"""The simpledog robot of the ``sweep`` cells, worked out from the
configuration's ``robot`` block alone: each leg's kinematic chain, the
Jacobians of its bodies and feet in closed form, and the floating-base
dynamics of the 13 bodies by Kane's method.

A leg i is a chain in its hip frame H_i (``hip_rot``, at ``hip_pos_m`` in
the base frame): joint 1 turns about the hip frame's z, joint 2 about
Rx(-pi/2)'s image of z after joint 1, joint 3 about the same axis at
o3 = R2 (l1, 0, d); link k's frame is R1 = Rz(q1), R2 = R1 Rx(-pi/2)
Rz(q2), R3 = R2 Rz(q3), its centre of mass at R1 c1, R2 c2 and
o3 + R3 c3, and the foot at o3 + R3 (l2, 0, 0).

The base moves with world velocity v and body-frame angular velocity w;
the generalised speeds are u = (v, w, qdot) (18). A point r on a body
moved by the base and joints j <= k has velocity
    v + R (w x r_b) + sum_j U_j qdot_j x (r - o_j)
(U_j the joint's world axis, o_j its world origin), whose partial
velocities are the Jacobian's columns, and with udot = 0 the bias
acceleration
    w_w x (v_r - v) + sum_j [(Omega_{j-1} x U_j qdot_j) x (r - o_j)
                             + U_j qdot_j x (v_r - v_{o_j})],
Omega_{j-1} the world angular velocity of the body that carries joint j.
Kane's equations then give M u_dot + h = tau_gen + J_c^T lambda with
M = sum m Jv^T Jv + Jw^T I_w Jw and
h = sum Jv^T m (a0 - g) + Jw^T (I_w alpha0 + omega x I_w omega).

Mass bookkeeping as the plant states it: the trunk is the controller's
total mass less the explicit link masses, with the base link's own
inertia (the lumped legs' parallel-axis terms left out). Every matrix
product goes through ``qp.Arith``, so the same code runs in float64 (the
reference) and with TF32 products (the control).
"""

from __future__ import annotations

import torch

from .qp import Arith


def _t(values, ar: Arith, device) -> torch.Tensor:
    return torch.tensor(values, dtype=ar.dtype, device=device)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def rot_z(angle):
    c, s = torch.cos(angle), torch.sin(angle)
    zero, one = torch.zeros_like(angle), torch.ones_like(angle)
    return torch.stack([torch.stack([c, -s, zero], -1),
                        torch.stack([s, c, zero], -1),
                        torch.stack([zero, zero, one], -1)], -2)


def quat_matrix(quat):
    """Rotation matrix of the unit quaternion (w, x, y, z) (base to world)."""
    w, x, y, z = quat.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1)], -2)


class Robot:
    """The configuration's robot in one precision, on one device."""

    def __init__(self, cfg: dict, ar: Arith, device):
        r = cfg["robot"]
        t = lambda v: _t(v, ar, device)  # noqa: E731
        self.ar = ar
        self.g = r["gravity_m_s2"]
        self.hip_pos = t(r["hip_pos_m"])  # (4,3)
        self.hip_rot = t(r["hip_rot"])  # (4,3,3)
        self.hip_offset = t(r["hip_offset_m"])
        self.base_mass = r["base_mass_kg"]
        self.leg_mass = t(r["leg_mass_kg"])
        self.com = t(r["com_in_base_m"])
        self.d, self.l1, self.l2 = (r["abduction_offset_m"], r["thigh_m"],
                                    r["shank_m"])
        self.link_mass = t(r["link_mass_kg"])  # (3,)
        self.link_com = t(r["link_com_m"])  # (3,3)
        self.link_inertia = torch.diag_embed(t(r["link_inertia_diag_kg_m2"]))
        self.trunk_mass = (r["base_mass_kg"] + sum(r["leg_mass_kg"])
                           - 4.0 * sum(r["link_mass_kg"]))
        self.trunk_inertia = torch.diag(t(r["base_link_inertia_diag_kg_m2"]))
        self.damping = r["joint_damping_n_m_s"]
        self.torque_limit = r["torque_limit_n_m"]
        self.reach = (self.d ** 2 + (self.l1 + self.l2) ** 2) ** 0.5
        self.rx = t([[1.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, -1.0, 0.0]])

    def legs(self, q):
        """Each leg's chain in its hip frame, q (..., 4, 3): link frames
        (..., 4, 3 links, 3, 3), joint axes and origins (..., 4, 3 joints,
        3), link centres of mass (..., 4, 3, 3) and the feet (..., 4, 3)."""
        mm = self.ar.mm
        r1 = rot_z(q[..., 0])
        r2 = mm(mm(r1, self.rx.expand_as(r1)), rot_z(q[..., 1]))
        r3 = mm(r2, rot_z(q[..., 2]))
        z = torch.zeros_like(q[..., 0])
        o3 = self.ar.mv(r2, torch.stack([z + self.l1, z, z + self.d], -1))
        ez = torch.stack([z, z, z + 1.0], -1)
        axes = torch.stack([ez, r2[..., :, 2], r3[..., :, 2]], -2)
        origins = torch.stack([torch.zeros_like(o3), torch.zeros_like(o3),
                               o3], -2)
        coms = torch.stack([self.ar.mv(r1, self.link_com[0].expand_as(o3)),
                            self.ar.mv(r2, self.link_com[1].expand_as(o3)),
                            o3 + self.ar.mv(r3, self.link_com[2]
                                            .expand_as(o3))], -2)
        foot = o3 + self.ar.mv(r3, torch.stack([z + self.l2, z, z], -1))
        return torch.stack([r1, r2, r3], -3), axes, origins, coms, foot

    def to_base(self, x_hip, per_leg: int = 1):
        """Vectors (..., 4, [n,] 3) of each leg's hip frame in the base
        frame; ``per_leg`` 2 where each leg has n of them."""
        H = self.hip_rot if per_leg == 1 else self.hip_rot[:, None]
        return self.ar.mv(H.expand(x_hip.shape + (3,)), x_hip)

    def feet_in_base(self, q):
        return self.hip_pos + self.to_base(self.legs(q)[4])

    def foot_jacobians_base(self, q):
        """d(foot in base)/dq of each leg: (..., 4, 3, 3), columns the
        joints."""
        _, axes, origins, _, foot = self.legs(q)
        cols = cross(axes, foot[..., None, :] - origins)  # (...,4,3 joints,3)
        return self.to_base(cols, per_leg=2).transpose(-1, -2)

    def gravity_torques(self, q, g_base):
        """Joint torques holding each leg's links against gravity g_base
        (..., 3) in the base frame: -sum_k m_k Jc_k^T g_hip."""
        _, axes, origins, coms, _ = self.legs(q)
        g_hip = self.ar.mv(self.hip_rot.mT.expand(q.shape[:-1] + (3, 3)),
                           g_base[..., None, :].expand(q.shape))
        tau = []
        for j in range(3):
            tj = 0.0
            for k in range(j, 3):  # link k is moved by joints j <= k
                col = cross(axes[..., j, :],
                            coms[..., k, :] - origins[..., j, :])
                tj = tj - self.link_mass[k] * (col * g_hip).sum(-1)
            tau.append(tj)
        return torch.stack(tau, -1)

    def dynamics(self, pos, quat, v, w_b, q, qd):
        """(M (B,18,18), h (B,18), feet (B,4,3), J_feet (B,4,3,18), feet's
        velocity (B,4,3) and bias acceleration (B,4,3), the kinematic hips
        (B,4,3)), all in the world frame, at the state given."""
        ar = self.ar
        B = pos.shape[0]
        R = quat_matrix(quat)  # (B,3,3)
        w_w = ar.mv(R, w_b)
        frames, axes, origins, coms, foot = self.legs(q)
        # world points and axes of each leg: hips, joint origins, link
        # centres of mass, feet
        RH = ar.mm(R[:, None], self.hip_rot.expand(B, 4, 3, 3))  # (B,4,3,3)
        hips = pos[:, None] + ar.mv(R[:, None], self.hip_pos.expand(B, 4, 3))

        def world(x):  # hip-frame points (B,4,n,3) -> world
            return hips[:, :, None] + ar.mv(RH[:, :, None], x)

        U = ar.mv(RH[:, :, None], axes)  # (B,4,3,3) world joint axes
        O = world(origins)  # (B,4,3,3)
        C = world(coms)
        F = world(foot[:, :, None])[:, :, 0]  # (B,4,3)
        qd_ax = U * qd[..., None]  # (B,4,3,3): U_j qdot_j

        def vel(r, upto):  # world velocity of points r (B,4,3) on the
            # body moved by joints < upto
            out = v[:, None] + cross(w_w[:, None], r - pos[:, None])
            for j in range(upto):
                out = out + cross(qd_ax[:, :, j], r - O[:, :, j])
            return out

        omega = [w_w[:, None].expand(B, 4, 3)]
        alpha = [torch.zeros_like(omega[0])]
        for j in range(3):
            alpha.append(alpha[-1] + cross(omega[-1], qd_ax[:, :, j]))
            omega.append(omega[-1] + qd_ax[:, :, j])
        v_origin = [vel(O[:, :, j], j) for j in range(3)]

        def bias(r, upto):  # bias acceleration of points r on that body
            vr = vel(r, upto)
            a = cross(w_w[:, None], vr - v[:, None])
            for j in range(upto):
                a = a + cross(cross(omega[j], qd_ax[:, :, j]), r - O[:, :, j])
                a = a + cross(qd_ax[:, :, j], vr - v_origin[j])
            return vr, a

        def jac_point(r, upto):  # (B,4,3,18)
            J = torch.zeros(B, 4, 3, 18, dtype=ar.dtype, device=pos.device)
            J[..., :3] = torch.eye(3, dtype=ar.dtype, device=pos.device)
            rb = r - pos[:, None]
            # R (w x r_b) = (w_w) x (r - p): columns R e_i x ... = -[r - p]x R
            for i in range(3):
                J[..., 3 + i] = cross(R[:, None, :, i], rb)
            for j in range(upto):
                col = cross(U[:, :, j], r - O[:, :, j])
                for leg in range(4):
                    J[:, leg, :, 6 + 3 * leg + j] = col[:, leg]
            return J

        def jac_rot(upto):  # (B,4,3,18) world angular velocity Jacobian
            J = torch.zeros(B, 4, 3, 18, dtype=ar.dtype, device=pos.device)
            J[..., 3:6] = R[:, None]
            for j in range(upto):
                for leg in range(4):
                    J[:, leg, :, 6 + 3 * leg + j] = U[:, leg, j]
            return J

        grav = torch.tensor([0.0, 0.0, -self.g], dtype=ar.dtype,
                            device=pos.device)
        M = torch.zeros(B, 18, 18, dtype=ar.dtype, device=pos.device)
        h = torch.zeros(B, 18, dtype=ar.dtype, device=pos.device)
        for k in range(3):  # link k of every leg: moved by joints 0..k
            Jv, Jw = jac_point(C[:, :, k], k + 1), jac_rot(k + 1)
            _, a0 = bias(C[:, :, k], k + 1)
            Rk = ar.mm(RH, frames[:, :, k])
            Iw = ar.mm(ar.mm(Rk, self.link_inertia[k].expand(B, 4, 3, 3)),
                       Rk.mT)
            m = self.link_mass[k]
            om, al = omega[k + 1], alpha[k + 1]
            M = M + (m * ar.mm(Jv.mT, Jv) + ar.mm(Jw.mT, ar.mm(Iw, Jw))).sum(1)
            torque = ar.mv(Iw, al) + cross(om, ar.mv(Iw, om))
            h = h + (ar.mv(Jv.mT, m * (a0 - grav))
                     + ar.mv(Jw.mT, torque)).sum(1)
        # the trunk: its centre of mass on the base, no joint
        c0 = pos + ar.mv(R, self.com.expand(B, 3))
        Jv = jac_point(c0[:, None].expand(B, 4, 3), 0)[:, 0]
        Jw = jac_rot(0)[:, 0]
        a0 = cross(w_w, cross(w_w, c0 - pos))
        Iw = ar.mm(ar.mm(R, self.trunk_inertia.expand(B, 3, 3)), R.mT)
        M = (M + self.trunk_mass * ar.mm(Jv.mT, Jv)
             + ar.mm(Jw.mT, ar.mm(Iw, Jw)))
        h = h + ar.mv(Jv.mT, self.trunk_mass * (a0 - grav)) + ar.mv(
            Jw.mT, cross(w_w, ar.mv(Iw, w_w)))
        Jf = jac_point(F, 3)
        vf, af = bias(F, 3)
        return M, h, F, Jf, vf, af, hips
