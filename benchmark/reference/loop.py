"""One control substep of the config-5 closed loop, worked out again from
the program's recorded state at its start (teacher-forced: the chaotic
loop does not decide agreement), from the configuration alone.

* **The controller's QP.** The virtual-model law (controller_gains_gazebo
  .yaml) asks for the base wrench, in the base frame,

      f = Kp R^T e_p + Kd R^T e_v + Kff R^T (v_t * (1,1,0)) + f_g
          + R^T (Kp * e_p,z e_z) + R^T (Kd * e_v,z e_z)
      tau = Kp_ang e_R + Kd_ang (R^T w_t - w) + R^T (Kff_ang * w_t,z e_z)
            + tau_g

  with e_p, e_v the target's position and velocity less the base's (world),
  e_R = -log(q_t^-1 q) the orientation error (a rotation vector), f_g and
  tau_g the gravity compensation of the trunk at c and of each leg's mass
  at its virtual hip; the QP seeks the ground-reaction forces x (3 a foot,
  base frame) minimising (Ax - b)^T S (Ax - b) + 1/2 x^T W x, A mapping the
  stance feet's forces (FK in the base frame) to the wrench about the base
  origin, under each stance foot's pyramid about its surface normal n
  (recorded, world, taken to the base frame): n.x >= f_min and
  mu n.x +- t_j.x >= 0 with t_1 = n x e_y, t_2 = n x t_1 (normalised).
  Swing feet's columns and rows are empty.
* **The stance torques** of the program's forces x: tau = -J^T x + G(q),
  clipped to the torque limit, J the foot's Jacobian in the base frame and
  G the leg's gravity torques (``robot.py``).
* **One step of the articulated plant** from the program's applied torques:
  ``substeps`` semi-implicit Euler steps of M udot + h = (0, tau - b qdot)
  + J_c^T lambda, each foot that the command supports and that is pinned,
  or touches the ground (within ``contact_tol_m``), and is within
  ``reach_share`` of the leg's reach pinned to its anchor (a new pin
  anchors where the foot stands, on the ground) by J_c udot + eps lambda =
  -a0 - (2/tau_B) J_c u - (1/tau_B^2)(p - anchor); feet whose normal force
  pulls (below ``release_force_n``) are released and the rest solved
  again. The masked constraint system is solved through its Schur
  complement (J_c M^-1 J_c^T + eps I) lambda = rhs.

A contact or release decision within ``MARGINS`` of its threshold is one
that float32 rounding can turn: the reference then follows the program.
It does so by trying the other side of each such decision (up to
``MAX_NEAR`` of them a scenario) and keeping the branch whose next state
lies nearest the program's; elsewhere it decides alone.
"""

from __future__ import annotations

import torch

from . import qp as ref_qp
from .robot import Robot, cross, quat_matrix

# Decisions that float32 rounding can turn: a foot's height over the
# ground within 1e-5 m of the contact tolerance, its hip-to-foot distance
# within 1e-5 m of the reach limit, its normal force within 0.5 N of the
# release threshold. A float32 plant's feet stand ~1e-7 m off a float64
# one's after a substep and its contact forces ~1e-2 N (CPU readings).
MARGINS = {"height_m": 1e-5, "reach_m": 1e-5, "force_n": 0.5}
MAX_NEAR = 3  # near decisions a scenario whose every branch is tried
GROUPS = ("q", "qd", "p", "quat", "v", "w")
# What a state group's change over a substep is measured against when it
# barely moves: positions and angles in m / rad, velocities in m/s, rad/s.
FLOORS = {"q": 1e-4, "p": 1e-4, "quat": 1e-4, "qd": 1e-2, "v": 1e-2,
          "w": 1e-2}


def _rot_vec_log(quat):
    """Rotation vector (angle * axis, |angle| <= pi) of a unit quaternion."""
    quat = torch.where(quat[..., :1] < 0, -quat, quat)
    n = torch.linalg.vector_norm(quat[..., 1:], dim=-1)
    angle = 2.0 * torch.atan2(n, quat[..., 0])
    scale = torch.where(n > 1e-12, angle / n.clamp(min=1e-300),
                        2.0 / quat[..., 0].clamp(min=1e-12))
    return scale[..., None] * quat[..., 1:]


def _quat_mul(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], -1)


def _quat_exp(phi):
    angle = torch.linalg.vector_norm(phi, dim=-1)
    k = torch.where(angle > 1e-12, torch.sin(0.5 * angle)
                    / angle.clamp(min=1e-300), 0.5 - angle * angle / 48.0)
    return torch.cat([torch.cos(0.5 * angle)[..., None], k[..., None] * phi],
                     -1)


def _conj(quat):
    return quat * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=quat.dtype,
                               device=quat.device)


def cast(rec: dict, ar: ref_qp.Arith) -> dict:
    """The recorded tensors, floating ones in the arithmetic's dtype."""
    return {k: v.to(ar.dtype) if v.is_floating_point() else v
            for k, v in rec.items()}


def controller_qp(robot: Robot, cfg: dict, rec: dict):
    """(A, b, S, W, D, d) of the recorded substeps' QPs."""
    ar, ctl = robot.ar, cfg["controller"]
    dev = rec["p"].device
    t = lambda v: torch.tensor(v, dtype=ar.dtype, device=dev)  # noqa: E731
    B = rec["p"].shape[0]
    R = quat_matrix(rec["quat"])
    Rt = R.mT

    def to_base(x):
        return ar.mv(Rt, x)

    ez = t([0.0, 0.0, 1.0])
    e_p = rec["target_p"] - rec["p"]
    e_v = rec["target_v"] - rec["v"]
    e_R = -_rot_vec_log(_quat_mul(_conj(rec["target_quat"]), rec["quat"]))
    e_w = to_base(rec["target_w"]) - rec["w"]
    k = ctl["gravity_percentage"]
    g_base = to_base(t([0.0, 0.0, -robot.g]).expand(B, 3))
    f_torso = -k * robot.base_mass * g_base
    f_legs = -k * robot.leg_mass[:, None] * g_base[:, None]  # (B,4,3)
    f_g = f_torso + f_legs.sum(1)
    tau_g = cross(robot.com.expand(B, 3), f_torso) + cross(
        (robot.hip_offset - robot.com).expand(B, 4, 3), f_legs).sum(1)
    kp, kd, kff = (t(ctl[n]) for n in ("vmc_kp_lin", "vmc_kd_lin",
                                        "vmc_kff_lin"))
    force = (kp * to_base(e_p) + kd * to_base(e_v)
             + kff * to_base(rec["target_v"] * t([1.0, 1.0, 0.0])) + f_g
             + to_base(kp * e_p * ez) + to_base(kd * e_v * ez))
    kp_a, kd_a, kff_a = (t(ctl[n]) for n in ("vmc_kp_ang", "vmc_kd_ang",
                                              "vmc_kff_ang"))
    torque = (kp_a * e_R + kd_a * e_w
              + to_base(kff_a * rec["target_w"] * ez) + tau_g)
    b = torch.cat([force, torque], -1)

    sup = rec["support"]
    m = sup.to(ar.dtype)[..., None, None]  # (B,4,1,1)
    feet = robot.feet_in_base(rec["q"])  # (B,4,3)
    zero = torch.zeros_like(feet)
    x_, y_, z_ = feet.unbind(-1)
    skew = torch.stack([torch.stack([zero[..., 0], -z_, y_], -1),
                        torch.stack([z_, zero[..., 0], -x_], -1),
                        torch.stack([-y_, x_, zero[..., 0]], -1)], -2)
    eye = torch.eye(3, dtype=ar.dtype, device=feet.device).expand(B, 4, 3, 3)
    A = torch.cat([torch.cat((eye * m).unbind(1), -1),
                   torch.cat((skew * m).unbind(1), -1)], -2)  # (B,6,12)
    n = ar.mv(Rt[:, None].expand(B, 4, 3, 3), rec["normal"])
    e_y = t([0.0, 1.0, 0.0]).expand(B, 4, 3)
    def unit(v):
        return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp(
            min=1e-9)

    t1 = unit(cross(n, e_y))
    t2 = unit(cross(n, t1))
    mu = ctl["friction_coeff"]
    rows = torch.stack([n, mu * n + t1, mu * n - t1, mu * n + t2,
                        mu * n - t2], -2) * m  # (B,4,5,3)
    D = torch.zeros(B, 20, 12, dtype=ar.dtype, device=feet.device)
    for leg in range(4):
        D[:, 5 * leg:5 * leg + 5, 3 * leg:3 * leg + 3] = rows[:, leg]
    fmin = t([ctl["min_normal_force_n"], 0.0, 0.0, 0.0, 0.0])
    d = torch.where(sup[..., None], fmin.expand(B, 4, 5),
                    torch.full((B, 4, 5), -1.0, dtype=ar.dtype,
                               device=feet.device)).reshape(B, 20)
    S = t(ctl["s_weights"]).expand(B, 6)
    W = torch.full((B, 12), ctl["w_regularizer"], dtype=ar.dtype,
                   device=feet.device)
    return A, b, S, W, D, d


def stance_torques(robot: Robot, rec: dict, x):
    """Each leg's stance torques from the forces x (B,12) (base frame):
    -J^T x + G(q), clipped to the torque limit."""
    B = x.shape[0]
    g_base = robot.ar.mv(quat_matrix(rec["quat"]).mT, torch.tensor(
        [0.0, 0.0, -robot.g], dtype=x.dtype, device=x.device).expand(B, 3))
    J = robot.foot_jacobians_base(rec["q"])  # (B,4,3,3)
    tau = -robot.ar.mv(J.mT, x.reshape(B, 4, 3)) + robot.gravity_torques(
        rec["q"], g_base)
    return tau.clamp(-robot.torque_limit, robot.torque_limit)


def _solve_constrained(robot, M, h, tau_gen, Jc, bc, mask, compliance):
    """udot and lambda (B,4,3) of the masked contact system."""
    ar = robot.ar
    B = M.shape[0]
    m3 = mask.repeat_interleave(3, -1)  # (B,12)
    A = torch.where(m3[..., None], Jc.reshape(B, 12, 18), torch.zeros_like(
        Jc.reshape(B, 12, 18)))
    rhs_b = torch.where(m3, bc.reshape(B, 12),
                        torch.zeros_like(m3, dtype=M.dtype))
    comp = torch.where(m3, compliance, 1.0).to(M.dtype)
    Minv_At = torch.linalg.solve(M, A.mT)  # (B,18,12)
    Minv_f = torch.linalg.solve(M, (tau_gen - h)[..., None])[..., 0]
    schur = ar.mm(A, Minv_At) + torch.diag_embed(comp)
    lam = torch.linalg.solve(schur, (rhs_b - ar.mv(A, Minv_f))[..., None])
    lam = lam[..., 0]
    udot = Minv_f + ar.mv(Minv_At, lam)
    return udot, lam.reshape(B, 4, 3)


def plant_substep(robot: Robot, pm: dict, st: dict, tau, support, gz, h,
                  flip=None):
    """One semi-implicit Euler step of the plant's state ``st``; returns
    the new state and, per foot, (near contact decision, near release
    decision) as two (B,4) masks. ``flip`` (B,4,2) turns the near
    decisions it marks."""
    ar = robot.ar
    B = tau.shape[0]
    M, hv, feet, Jc, vf, af, hips = robot.dynamics(
        st["p"], st["quat"], st["v"], st["w"], st["q"], st["qd"])
    over = feet[..., 2] - (gz + pm["contact_tol_m"])
    touching = over <= 0.0
    ext = (torch.linalg.vector_norm(feet - hips, dim=-1)
           - pm["reach_share"] * robot.reach)
    reachable = ext < 0.0
    pinned = st["pinned"]
    near_touch = (support & ~pinned & reachable
                  & (over.abs() < MARGINS["height_m"]))
    near_reach = (support & (pinned | touching)
                  & (ext.abs() < MARGINS["reach_m"]))
    near_c = near_touch | near_reach
    mask = support & (pinned | touching) & reachable
    if flip is not None:
        mask = mask ^ (near_c & flip[..., 0])
    new_pin = mask & ~pinned
    ground = torch.cat([feet[..., :2], gz[..., None]], -1)
    anchors = torch.where(new_pin[..., None], ground, st["anchors"])
    kd, kp = 2.0 / pm["baumgarte_tau_s"], 1.0 / pm["baumgarte_tau_s"] ** 2
    bc = -af - kd * vf - kp * (feet - anchors)
    u = torch.cat([st["v"], st["w"], st["qd"].reshape(B, 12)], -1)
    tau_gen = torch.cat([torch.zeros(B, 6, dtype=u.dtype, device=u.device),
                         (tau - robot.damping * st["qd"]).reshape(B, 12)], -1)
    eps = pm["contact_compliance"]
    _, lam = _solve_constrained(robot, M, hv, tau_gen, Jc, bc, mask, eps)
    near_r = mask & ((lam[..., 2] - pm["release_force_n"]).abs()
                     < MARGINS["force_n"])
    keep = mask & (lam[..., 2] >= pm["release_force_n"])
    if flip is not None:
        keep = keep ^ (near_r & flip[..., 1])
    udot, _ = _solve_constrained(robot, M, hv, tau_gen, Jc, bc, keep, eps)
    u = u + h * udot
    quat = _quat_mul(st["quat"], _quat_exp(h * u[:, 3:6]))
    quat = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
    qd = u[:, 6:].reshape(B, 4, 3)
    out = {"p": st["p"] + h * u[:, :3], "quat": quat, "v": u[:, :3],
           "w": u[:, 3:6], "q": st["q"] + h * qd, "qd": qd, "pinned": keep,
           "anchors": anchors}
    return out, near_c, near_r


def plant_step(robot: Robot, cfg: dict, rec: dict, tau, flips=None):
    """The plant's state after one control substep from ``rec`` under the
    joint torques ``tau`` (B,4,3); ``flips`` (B, substeps, 4, 2) turns near
    decisions. Returns (state, near (B, substeps, 4, 2))."""
    pm = cfg["plant_model"]
    n = pm["substeps"]
    h = pm["control_dt_s"] / n
    st = {k: rec[k] for k in ("p", "quat", "v", "w", "q", "qd", "pinned",
                              "anchors")}
    near = []
    for i in range(n):
        st, nc, nr = plant_substep(robot, pm, st, tau, rec["support"],
                                   rec["gz"], h,
                                   None if flips is None else flips[:, i])
        near.append(torch.stack([nc, nr], -1))
    return st, torch.stack(near, 1)


def state_errors(st: dict, prog: dict, start: dict) -> torch.Tensor:
    """(B,) the next state's error: per group of ``GROUPS``, the largest
    difference from the program's over the group's largest change in the
    substep (plus its floor), the largest over the groups."""
    worst = None
    for g in GROUPS:
        ref, got, was = (x[g].double().flatten(1) for x in (st, prog, start))
        if g == "quat":  # q and -q are one rotation
            got = torch.where((ref * got).sum(-1, keepdim=True) < 0, -got,
                              got)
        err = (got - ref).abs().amax(-1) / ((ref - was).abs().amax(-1)
                                           + FLOORS[g])
        worst = err if worst is None else torch.maximum(worst, err)
    return worst


def follow_program(robot: Robot, cfg: dict, rec: dict, tau, prog: dict):
    """The reference's next state, each near decision taken as the program
    took it: every branch over a scenario's first ``MAX_NEAR`` near
    decisions is tried and the one nearest the program's state kept.
    Returns (state, state error (B,), near decisions per scenario (B,))."""
    st, near = plant_step(robot, cfg, rec, tau)
    err = state_errors(st, prog, rec)
    count = near.flatten(1).sum(-1)
    rows = (count > 0).nonzero().flatten()
    if rows.numel():
        sub = {k: v[rows] for k, v in rec.items()}
        sub_prog = {k: v[rows] for k, v in prog.items()}
        slots = near[rows].flatten(1)  # (n, substeps*4*2)
        order = torch.argsort((~slots).to(torch.int8), dim=-1, stable=True)
        best_err, best = err[rows], {k: v[rows] for k, v in st.items()}
        for branch in range(1, 2 ** MAX_NEAR):
            flip = torch.zeros_like(slots)
            for j in range(MAX_NEAR):
                if branch >> j & 1:
                    flip.scatter_(1, order[:, j:j + 1], True)
            flip &= slots  # only near decisions turn
            st_b, _ = plant_step(robot, cfg, sub, tau[rows],
                                 flip.reshape(near[rows].shape))
            e = state_errors(st_b, sub_prog, sub)
            better = e < best_err
            best_err = torch.where(better, e, best_err)
            for k in best:
                m = better.reshape((-1,) + (1,) * (best[k].dim() - 1))
                best[k] = torch.where(m, st_b[k], best[k])
        err = err.clone()
        err[rows] = best_err
        for k in st:
            st[k] = st[k].clone()
            st[k][rows] = best[k]
    return st, err, count
