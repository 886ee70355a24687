"""Core state/model types of the PyTorch port (≙ ``quadruped_locomotion_tpu/
types.py``).

Every state type is a ``@dataclass`` of tensors whose leading dimensions
are the scenario batch; the robot model and gains are unbatched and
broadcast. Leg order LF=0, RF=1, RH=2, LH=3; per-leg joints are
(HAA, HFE, KFE).
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import torch

LF, RF, RH, LH = 0, 1, 2, 3  # leg order of every (..., 4, ...) array
GRAVITY = 9.8  # m/s², the reference's hard-coded value

# IK solution-branch indices: OUT_LEFT=0, IN_RIGHT=1, IN_LEFT=2, OUT_RIGHT=3
IK_BRANCH = {"OUT_LEFT": 0, "IN_RIGHT": 1, "IN_LEFT": 2, "OUT_RIGHT": 3}
# Default limb configuration "><": LF=IN_LEFT, RF=OUT_LEFT, RH=IN_LEFT, LH=OUT_LEFT.
DEFAULT_LIMB_CONFIG = ("IN_LEFT", "OUT_LEFT", "IN_LEFT", "OUT_LEFT")

# The four whole-robot configure strings of the reference's
# QuadrupedState::setLimbConfigure, in leg order (LF, RF, RH, LH).
LIMB_CONFIGURE = {
    "<<": ("IN_LEFT", "OUT_LEFT", "OUT_LEFT", "IN_LEFT"),
    "<>": ("OUT_LEFT", "IN_LEFT", "OUT_LEFT", "IN_LEFT"),
    "><": DEFAULT_LIMB_CONFIG,
    ">>": ("OUT_LEFT", "IN_LEFT", "IN_LEFT", "OUT_LEFT"),
}


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU. Raises instead of falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def limb_configure_branches(configure: str, device=None) -> torch.Tensor:
    """Configure string ('<<', '<>', '><', '>>') -> (4,) int32 IK-branch
    tensor on ``device`` (default CUDA). Raises KeyError on unknown
    strings."""
    names = LIMB_CONFIGURE[configure]
    return torch.tensor([IK_BRANCH[n] for n in names], dtype=torch.int32,
                        device=resolve_device(device))


@functools.lru_cache(maxsize=None)
def _const(values, dtype, device) -> torch.Tensor:
    # made outside any torch.func transform that may be running (the leg
    # dynamics call this under jacfwd and vmap): a tensor made inside one
    # belongs to its level, and the cache hands it to later calls at others
    with torch._C._DisableFuncTorch():
        return torch.tensor(values, dtype=dtype, device=device)


def const(values, like: torch.Tensor) -> torch.Tensor:
    """The constant ``values`` (a number or nested tuples) on ``like``'s
    dtype and device, made once per process and reused after: a tick
    captured in a CUDA graph may launch kernels but not copy from the
    host, so the tick's constants are made by an eager run before the
    capture. Callers must not write into the result."""
    return _const(values, like.dtype, like.device)


def full_f32_matmuls() -> None:
    """Keep float32 matrix products in full float32 (no TF32): the G/g
    formation and the QP's KKT systems need it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def map_tensors(obj, fn):
    """``fn`` applied to every tensor leaf of a tree of dataclasses,
    NamedTuples, tuples, lists and dicts; other leaves pass through."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(
            obj,
            **{f.name: map_tensors(getattr(obj, f.name), fn)
               for f in dataclasses.fields(obj)},
        )
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(map_tensors(v, fn) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(map_tensors(v, fn) for v in obj)
    if isinstance(obj, dict):
        return {k: map_tensors(v, fn) for k, v in obj.items()}
    return obj


def where_tree(mask: torch.Tensor, a, b):
    """``a`` where ``mask`` (B,) is set, else ``b``, leaf by leaf over two
    structs of the same layout whose leaves lead with the B axis."""
    if isinstance(a, torch.Tensor):
        m = mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim()))
        return torch.where(m, a, b)
    return dataclasses.replace(a, **{
        f.name: where_tree(mask, getattr(a, f.name), getattr(b, f.name))
        for f in dataclasses.fields(a)})


class TensorStruct:
    """Mixin for dataclasses of tensors: functional ``replace`` and ``to``."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def to(self, device):
        return map_tensors(self, lambda t: t.to(device))


def _f(x, dtype, device):
    return torch.as_tensor(x, dtype=dtype, device=device)


@dataclass
class RobotModel(TensorStruct):
    """Static simpledog description (d=0.1, l1=l2=0.25 analytic leg)."""

    hip_pos: torch.Tensor  # (4,3) kinematic hip (HAA) position in base
    hip_rot: torch.Tensor  # (4,3,3) base←hip rotation
    d: torch.Tensor  # () abduction offset
    l1: torch.Tensor  # () thigh
    l2: torch.Tensor  # () shank
    ik_branch: torch.Tensor  # (4,) int per-leg IK branch
    hip_offset: torch.Tensor  # (4,3) virtual hips (Raibert / leg CoM proxy)
    base_mass: torch.Tensor  # ()
    leg_mass: torch.Tensor  # (4,)
    com_in_base: torch.Tensor  # (3,)
    link_mass: torch.Tensor  # (3,)
    link_com: torch.Tensor  # (3,3) CoM in each link frame
    link_inertia: torch.Tensor  # (3,3,3) about the link CoM
    torque_limit: torch.Tensor  # () ±300 N·m
    base_inertia: torch.Tensor  # (3,3) lumped trunk inertia
    joint_damping: torch.Tensor  # () viscous joint damping [N·m·s/rad]

    @classmethod
    def simpledog(cls, device=None, dtype=torch.float32) -> "RobotModel":
        dev = resolve_device(device)
        f = lambda x: _f(x, dtype, dev)  # noqa: E731
        rot_left = [[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]]
        rot_right = [[0.0, 0.0, -1.0], [0.0, -1.0, 0.0], [-1.0, 0.0, 0.0]]
        hips = [(0.42, 0.075), (0.42, -0.075), (-0.42, -0.075), (-0.42, 0.075)]
        # base_link inertia + 6 kg point masses at the virtual hips
        # (parallel-axis), accumulated in float32 like the reference.
        base_inertia = torch.diag(torch.tensor([0.74932, 2.3017, 2.9675]))
        for hx, hy in hips:
            r = torch.tensor([hx, hy, 0.0])
            base_inertia = base_inertia + 6.0 * (
                torch.dot(r, r) * torch.eye(3) - torch.outer(r, r)
            )
        return cls(
            hip_pos=f([[0.4, 0.175, 0.0], [0.4, -0.175, 0.0],
                       [-0.4, -0.175, 0.0], [-0.4, 0.175, 0.0]]),
            hip_rot=f([rot_left, rot_right, rot_right, rot_left]),
            d=f(0.1),
            l1=f(0.25),
            l2=f(0.25),
            ik_branch=torch.tensor(
                [IK_BRANCH[c] for c in DEFAULT_LIMB_CONFIG], device=dev
            ),
            hip_offset=f([[hx, hy, 0.0] for hx, hy in hips]),
            base_mass=f(27.0),
            leg_mass=f([6.0] * 4),
            com_in_base=f([0.0, 0.0, 0.0]),
            link_mass=f([1.1709, 1.3902, 1.3523]),
            link_com=f([[0.0, 0.012793, -0.00023552],
                        [0.11439, 0.00028184, 0.05942],
                        [0.087825, 0.0000153, -0.016708]]),
            link_inertia=torch.stack([
                torch.diag(f([0.001719, 0.0013167, 0.0021511])),
                torch.diag(f([0.0030209, 0.026875, 0.028484])),
                torch.diag(f([0.00053032, 0.0091429, 0.009338])),
            ]),
            torque_limit=f(300.0),
            base_inertia=f(base_inertia),
            joint_damping=f(0.2),
        )

    @property
    def total_mass(self) -> torch.Tensor:
        return self.base_mass + self.leg_mass.sum()


@dataclass
class BaseState(TensorStruct):
    """Floating base: world position/orientation (wxyz, base→world), world
    linear velocity, base-frame angular velocity. Shapes (..., 3|4)."""

    position: torch.Tensor
    quaternion: torch.Tensor
    linear_velocity: torch.Tensor
    angular_velocity: torch.Tensor

    @classmethod
    def identity(cls, batch=(), device=None, dtype=torch.float32):
        dev = resolve_device(device)
        z3 = torch.zeros(*batch, 3, dtype=dtype, device=dev)
        quat = torch.zeros(*batch, 4, dtype=dtype, device=dev)
        quat[..., 0].fill_(1.0)  # a fill kernel: no host copy to capture
        return cls(position=z3, quaternion=quat,
                   linear_velocity=z3.clone(), angular_velocity=z3.clone())


@dataclass
class RobotState(TensorStruct):
    """Measured robot state: base + joints + contact bookkeeping."""

    base: BaseState
    q: torch.Tensor  # (...,4,3)
    qd: torch.Tensor  # (...,4,3)
    tau: torch.Tensor  # (...,4,3)
    support: torch.Tensor  # (...,4) bool
    surface_normal: torch.Tensor  # (...,4,3) world frame

    @classmethod
    def neutral(cls, batch=(), device=None, dtype=torch.float32):
        dev = resolve_device(device)
        z43 = torch.zeros(*batch, 4, 3, dtype=dtype, device=dev)
        normal = z43.clone()
        normal[..., 2].fill_(1.0)
        return cls(
            base=BaseState.identity(batch, dev, dtype),
            q=z43, qd=z43.clone(), tau=z43.clone(),
            support=torch.ones(*batch, 4, dtype=torch.bool, device=dev),
            surface_normal=normal,
        )


@dataclass
class BaseTarget(TensorStruct):
    """Desired base motion handed from the gait engine to the controller."""

    position: torch.Tensor  # (...,3) world
    quaternion: torch.Tensor  # (...,4)
    linear_velocity: torch.Tensor  # (...,3) world
    angular_velocity: torch.Tensor  # (...,3) base

    @classmethod
    def from_base(cls, base: BaseState) -> "BaseTarget":
        return cls(position=base.position, quaternion=base.quaternion,
                   linear_velocity=base.linear_velocity,
                   angular_velocity=base.angular_velocity)


@dataclass
class VmcGains(TensorStruct):
    """Virtual-model-controller gains (controller_gains_gazebo.yaml)."""

    kp_lin: torch.Tensor  # (3,)
    kd_lin: torch.Tensor
    kff_lin: torch.Tensor
    kp_ang: torch.Tensor
    kd_ang: torch.Tensor
    kff_ang: torch.Tensor
    gravity_percentage: torch.Tensor  # ()

    @classmethod
    def gazebo_defaults(cls, device=None, dtype=torch.float32) -> "VmcGains":
        dev = resolve_device(device)
        f = lambda x: _f(x, dtype, dev)  # noqa: E731
        return cls(
            kp_lin=f([5000.0, 5000.0, 10000.0]),
            kd_lin=f([5000.0, 4000.0, 5000.0]),
            kff_lin=f([10.0, 10.0, 100.0]),
            kp_ang=f([10000.0, 10000.0, 4000.0]),
            kd_ang=f([1000.0, 1000.0, 1000.0]),
            kff_ang=f([0.2, 0.2, 1000.0]),
            gravity_percentage=f(1.0),
        )


@dataclass
class CfdParams(TensorStruct):
    """Contact-force-distribution QP parameters."""

    s_weights: torch.Tensor  # (6,) diag of S
    w_regularizer: torch.Tensor  # () 1e-4
    friction_coeff: torch.Tensor  # () 0.6
    min_normal_force: torch.Tensor  # () 10 N

    @classmethod
    def defaults(cls, device=None, dtype=torch.float32) -> "CfdParams":
        dev = resolve_device(device)
        f = lambda x: _f(x, dtype, dev)  # noqa: E731
        return cls(
            s_weights=f([1.0, 5.0, 1.0, 10.0, 10.0, 5.0]),
            w_regularizer=f(1e-4),
            friction_coeff=f(0.6),
            min_normal_force=f(10.0),
        )


@dataclass
class SwingGains(TensorStruct):
    """Task-space PD of the swing-leg computed-torque controller."""

    kp: torch.Tensor  # (3,)
    kd: torch.Tensor  # (3,)

    @classmethod
    def defaults(cls, device=None, dtype=torch.float32) -> "SwingGains":
        dev = resolve_device(device)
        return cls(kp=_f([1000.0] * 3, dtype, dev),
                   kd=_f([200.0] * 3, dtype, dev))
