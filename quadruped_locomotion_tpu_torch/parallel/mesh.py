"""Meshes of ranks and the sharded rollouts (≙ ``quadruped_locomotion_tpu/
parallel/mesh.py``).

A :class:`Mesh` is the first n ranks of the initialized process group,
one process per card. The scenario batch is data-parallel over it:
:func:`shard_batch` hands each rank a contiguous block of the leading
axis, in rank order, as ``NamedSharding(mesh, P("data"))`` places it, and
raises where the mesh size does not divide the batch. A sharded function
takes and returns the rank's own shard; :func:`gather_batch` gives back
the whole batch where JAX returns a global array. The global metrics ride
:func:`psum` (``all_reduce(SUM)``) and :func:`pmax` (``all_reduce(MAX)``)
over the mesh's group, so every rank holds the same values.

Under NCCL the collectives run on the rank's card. Under gloo, the
backend of the CPU and of several ranks that share one card (NCCL refuses
two ranks on one GPU), they move host copies: gloo is a host transport,
and what it reduces here is a few scalars per call. The shards themselves
stay on the rank's device either way.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..types import (
    BaseTarget, CfdParams, RobotModel, VmcGains, full_f32_matmuls,
    map_tensors, resolve_device,
)

DATA_AXIS = "data"


@dataclass(frozen=True)
class Mesh:
    """The ranks that a sharded function runs on, and this rank's place."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]
    rank: int | None  # this process's rank, None where it is outside the mesh
    world_size: int  # ranks in the process group
    device: torch.device  # where this rank's shard lives
    backend: str  # "nccl" or "gloo"
    group: object  # process group over the mesh's ranks

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def comm_device(self) -> torch.device:
        """Where the collectives' tensors live: the card under NCCL, the
        host under gloo."""
        return self.device if self.backend == "nccl" else torch.device("cpu")


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` if given, else ``cuda:LOCAL_RANK``;
    a CUDA device without an index is ``cuda:LOCAL_RANK`` too. Raises
    where CUDA is absent."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def ensure_process_group(device: torch.device) -> None:
    """With no process group initialized, initialize a world of one in
    this process (a ``HashStore``; NCCL for a CUDA device, gloo for the
    CPU), so that a mesh of one rank runs real collectives."""
    if dist.is_initialized():
        return
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """A one-axis mesh over the first ``n_devices`` ranks (all of them by
    default). Collective: every rank of the group calls it, those outside
    the mesh too (``Mesh.rank`` None). Raises if fewer ranks exist."""
    dev = rank_device(device)
    if not dist.is_initialized() and n_devices not in (None, 1):
        raise ValueError(f"need {n_devices} devices, have 1 "
                         "(no process group is initialized)")
    ensure_process_group(dev)
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"need {n} devices, have {world}")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    rank = dist.get_rank()
    return Mesh((DATA_AXIS,), (n,), rank if rank < n else None, world, dev,
                dist.get_backend(), group)


def _member(mesh: Mesh) -> int:
    if mesh.rank is None:
        raise ValueError(f"this rank is outside the mesh {mesh.shape}")
    return mesh.rank


def shard_batch(mesh: Mesh, tree):
    """This rank's block of the leading axis of every tensor in ``tree``,
    on the rank's device."""
    rank = _member(mesh)

    def take(x):
        if x.dim() == 0 or x.shape[0] % mesh.size:
            raise ValueError(f"a batch of shape {tuple(x.shape)} does not "
                             f"split evenly over {mesh.size} ranks")
        per = x.shape[0] // mesh.size
        return x[rank * per:(rank + 1) * per].to(mesh.device).contiguous()

    return map_tensors(tree, take)


def replicate(mesh: Mesh, tree):
    """Every tensor in ``tree`` whole on the rank's device."""
    return map_tensors(tree, lambda x: x.to(mesh.device))


def gather_batch(mesh: Mesh, tree):
    """The whole batch from every rank's shard (``all_gather`` over the
    mesh, blocks in rank order), on the rank's device."""
    _member(mesh)

    def gather(x):
        wire = x.to(torch.uint8) if x.dtype == torch.bool else x
        wire = wire.detach().to(mesh.comm_device).contiguous()
        parts = [torch.empty_like(wire) for _ in range(mesh.size)]
        dist.all_gather(parts, wire, group=mesh.group)
        out = torch.cat(parts).to(mesh.device)
        return out.bool() if x.dtype == torch.bool else out

    return map_tensors(tree, gather)


def _all_reduce(mesh: Mesh, value: torch.Tensor, op) -> torch.Tensor:
    t = value.detach().to(mesh.comm_device).clone()
    dist.all_reduce(t, op=op, group=mesh.group)
    return t.to(mesh.device)


def psum(mesh: Mesh, value: torch.Tensor) -> torch.Tensor:
    """Sum of ``value`` over the mesh's ranks (≙ ``jax.lax.psum``)."""
    return _all_reduce(mesh, value, dist.ReduceOp.SUM)


def pmax(mesh: Mesh, value: torch.Tensor) -> torch.Tensor:
    """Maximum of ``value`` over the mesh's ranks (≙ ``jax.lax.pmax``)."""
    return _all_reduce(mesh, value, dist.ReduceOp.MAX)


def global_mean(mesh: Mesh, local_sum: torch.Tensor, local_count: int):
    """``psum(local_sum) / psum(local_count)`` in one collective."""
    tot = psum(mesh, torch.stack([local_sum,
                                  torch.full_like(local_sum, local_count)]))
    return tot[0] / tot[1]


def make_sharded_rollout(mesh: Mesh, steps: int, dt: float = 0.0025,
                         qp_iters: int = 15):
    """A mesh-sharded balance rollout: (SimState shard, BaseTarget shard)
    → (final SimState shard, global mean base-position error, global max
    KKT). Each step runs ``balance_update`` (the generic QP, as in the JAX
    package) and one massless plant step on the shard."""
    from ..control.balance_controller import balance_update
    from ..rollout import simulator as simlib

    dev = mesh.device
    model = RobotModel.simpledog(dev)
    gains = VmcGains.gazebo_defaults(dev)
    cfd = CfdParams.defaults(dev)

    def run(sims, targets):
        full_f32_matmuls()
        s, kkt = sims, None
        for _ in range(steps):
            tau, diag = balance_update(model, gains, cfd, s.robot, targets,
                                       qp_iters=qp_iters)
            s = simlib.step(model, s, tau, dt)
            k = diag.distribution.qp_solution.kkt_error.amax()
            kkt = k if kkt is None else torch.maximum(kkt, k)
        err = torch.linalg.norm(s.robot.base.position - targets.position,
                                dim=-1).sum()
        return (s, global_mean(mesh, err, sims.time.shape[0]),
                pmax(mesh, kkt))

    return run


def make_sharded_locomotion_rollout(mesh: Mesh, ticks: int, qp_iters: int = 15,
                                    qp_backend: str = "auto"):
    """The mesh-sharded full closed loop (gait engine, contact FSM, VMC,
    one batched QP dispatch per 400 Hz substep, torque map, articulated
    plant): (LocomotionState shard, Command shard) → (final state shard,
    global max KKT, global upright fraction (base z > 0.25)). Each rank
    runs ``closed_loop.rollout`` on its shard; ``qp_backend`` "auto" is
    the CUDA kernel on the card and its plain version on the CPU
    (JAX's "pallas" on TPU), "generic" the generic IPM (JAX's "xla")."""
    from ..control.locomotion import ControllerParams
    from ..gait.phase import GaitParams
    from ..rollout import closed_loop as cl

    dev = mesh.device
    model = RobotModel.simpledog(dev)
    params = ControllerParams.defaults(dev)
    gp = GaitParams.trot_defaults(dev)

    def run(ls, cmds):
        ls2, tel = cl.rollout(model, params, gp, ls, cmds, ticks,
                              qp_iters=qp_iters, qp_backend=qp_backend,
                              device=dev)
        upright = (tel["base_position"][-1, :, 2] > 0.25).float().sum()
        return (ls2, pmax(mesh, tel["qp_kkt"].amax()),
                global_mean(mesh, upright, tel["base_position"].shape[1]))

    return run


def shard_rollout_step(mesh: Mesh, batch: int, steps: int = 2) -> None:
    """Run one small sharded balance rollout from the default stance (the
    dry-run hook of ``__graft_entry__.py``'s multi-chip check); raises if
    its metrics are not finite."""
    from ..rollout import simulator as simlib

    model = RobotModel.simpledog(mesh.device)
    sim = simlib.default_stance_state(model, height=0.4, batch=(batch,))
    target = BaseTarget.from_base(sim.robot.base)
    _, err, kkt = make_sharded_rollout(mesh, steps)(
        shard_batch(mesh, sim), shard_batch(mesh, target))
    if not (torch.isfinite(err) and torch.isfinite(kkt)):
        raise RuntimeError("sharded rollout produced non-finite metrics")
