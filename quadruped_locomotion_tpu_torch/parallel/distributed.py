"""Several cards and hosts: joining the process group, pod meshes, the
sharded QP sweep and scaling-efficiency measurement (≙
``quadruped_locomotion_tpu/parallel/distributed.py``).

One process runs per card. ``torchrun`` starts them and describes the
group in its environment, which :func:`initialize_multihost` reads. The
scenario batch is split over every rank, each rank solves its shard of
force-distribution QPs on its card (one launch of the CUDA kernel per
sweep), and the global health metrics (the KKT maximum, the mean wrench
error) ride ``all_reduce`` over the mesh's group: no gather of the
solutions inside the loop.

A pod mesh lays the ranks out as hosts × local cards, on a ``dcn`` and an
``ici`` axis. A reduction over both axes, the only kind the sweep makes,
is one ``all_reduce`` over the world group: NCCL routes it over NVLink
within a host and over the network between hosts, as XLA lowers JAX's
two-axis ``psum``. So the mesh holds no group per host.

:func:`run_local_ranks` starts gloo ranks on one host without
``torchrun``, for the tests on the CPU and for several ranks that share
one card (NCCL refuses two ranks on one GPU).
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from .mesh import (
    Mesh, ensure_process_group, global_mean, make_mesh, pmax, rank_device,
    shard_batch,
)

DCN_AXIS = "dcn"  # across hosts
ICI_AXIS = "ici"  # across cards within a host


def initialize_multihost(init_method: str | None = None,
                         world_size: int | None = None,
                         rank: int | None = None, device=None,
                         backend: str | None = None) -> bool:
    """Join the process group of a run of several processes (≙
    ``jax.distributed.initialize``).

    Arguments default to torchrun's environment: ``init_method``
    ``tcp://$MASTER_ADDR:$MASTER_PORT``, ``$WORLD_SIZE`` and ``$RANK``;
    ``device`` defaults to ``cuda:$LOCAL_RANK``. ``backend`` defaults to
    NCCL for a CUDA device and gloo for the CPU. Returns True if this
    process is one of several ranks (joined now or before), False for a
    single process (no-op). Safe to call twice."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1:
        return False
    if rank is None:
        rank = int(os.environ["RANK"])
    if init_method is None:
        init_method = (f"tcp://{os.environ['MASTER_ADDR']}:"
                       f"{os.environ['MASTER_PORT']}")
    dev = rank_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return True


def make_pod_mesh(device=None) -> Mesh:
    """The (dcn, ici) mesh over every rank: hosts × local cards, with
    ``$LOCAL_WORLD_SIZE`` ranks per host (all of them by default, so a
    single host gets shape (1, n)). Ranks are numbered host by host, as
    torchrun numbers them."""
    dev = rank_device(device)
    ensure_process_group(dev)
    world, rank = dist.get_world_size(), dist.get_rank()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
    if world % local:
        raise ValueError(f"{world} ranks not divisible by {local} per host")
    return Mesh((DCN_AXIS, ICI_AXIS), (world // local, local), rank, world,
                dev, dist.get_backend(), dist.group.WORLD)


def make_sharded_qp_sweep(mesh: Mesh, iters: int = 15, backend: str = "auto"):
    """The mesh-sharded force-distribution QP sweep: (A, b, S, W, D, d)
    shards → (QpSolution of the shard, global max KKT, global mean wrench
    error max_i |(Ax − b)_i|), reduced over every mesh axis.

    ``backend`` is ``solve_fd_qp_batched``'s: "auto" launches the CUDA
    kernel once per call on the card and runs its plain version on the
    CPU (JAX's "pallas"); "generic" is the generic IPM (JAX's "xla")."""
    from ..control.force_distribution import solve_fd_qp_batched
    from ..model.kinematics import mv

    def run(A, b, S, W, D, d):
        sol = solve_fd_qp_batched(A, b, S, W, D, d, iters=iters,
                                  backend=backend)
        err = (mv(A, sol.x) - b).abs().amax(-1).sum()
        return (sol, pmax(mesh, sol.kkt_error.amax()),
                global_mean(mesh, err, A.shape[0]))

    return run


def shard_problem(mesh: Mesh, tree):
    """This rank's block of a batched problem (the batch axis split over
    every mesh axis, in rank order)."""
    return shard_batch(mesh, tree)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_sweep(mesh: Mesh, problem, iters: int, reps: int,
                backend: str = "auto"):
    """(solves/s of the whole batch, global max KKT, global mean wrench
    error) of ``reps`` sharded sweeps after a warm one; the time is the
    slowest rank's, on the host clock between device synchronisations."""
    sweep = make_sharded_qp_sweep(mesh, iters=iters, backend=backend)
    shard = shard_problem(mesh, problem)
    sweep(*shard)  # warm: the kernel is built and loaded on first use
    _sync(mesh.device)
    pmax(mesh, torch.zeros((), device=mesh.device))  # start together
    t0 = time.perf_counter()
    for _ in range(reps):
        _, kkt, err = sweep(*shard)
    _sync(mesh.device)
    dt = pmax(mesh, torch.tensor((time.perf_counter() - t0) / reps,
                                 dtype=torch.float64, device=mesh.device))
    return problem[0].shape[0] / float(dt), float(kkt), float(err)


def _from_rank0(mesh: Mesh, values: list[float]) -> list[float]:
    """Rank 0's ``values`` on every rank of ``mesh``: ranks that sat out
    a measurement wait here for it."""
    t = torch.tensor(values, dtype=torch.float64, device=mesh.comm_device)
    dist.broadcast(t, src=0, group=mesh.group)
    return t.tolist()


def _tile(problem, n: int):
    return tuple(torch.cat([x] * n) for x in problem)


def measure_sharding_overhead(problem, iters: int = 15, reps: int = 10,
                              mesh: Mesh | None = None) -> dict:
    """Sharding and collective overhead on a fixed pool of ranks: the
    same batch (``problem`` once per mesh rank) solved on rank 0 alone
    and sharded over the mesh; efficiency = rate_sharded / rate_unsharded.
    Collective: every rank calls it and gets the same result."""
    mesh = mesh or make_mesh()
    n = mesh.size
    prob_n = _tile(problem, n)
    mesh1 = make_mesh(1, device=mesh.device)
    rate1 = (_time_sweep(mesh1, prob_n, iters, reps)[0]
             if mesh1.rank is not None else 0.0)
    (rate1,) = _from_rank0(mesh, [rate1])
    rate_n, kkt, err = _time_sweep(mesh, prob_n, iters, reps)
    return {"devices": n, "rate_unsharded": rate1, "rate_sharded": rate_n,
            "efficiency": rate_n / rate1, "max_kkt": kkt,
            "mean_wrench_err": err}


def measure_scaling(problem, iters: int = 15, reps: int = 10,
                    device_counts: list[int] | None = None,
                    backend: str = "auto", device=None) -> dict:
    """Weak scaling of the sharded QP sweep over the first n ranks:
    ``problem`` is one rank's batch, and n ranks solve n × that batch.
    Efficiency(n) = rate(n) / (n × rate(first count) / first count).
    Collective: every rank calls it; ranks outside a mesh wait for rank
    0's figures, which every rank returns."""
    world_mesh = make_mesh(device=device)
    world = world_mesh.size
    if device_counts is None:
        device_counts = sorted({1, 2, world} & set(range(1, world + 1)))
    results, rate1 = {}, None
    for n in device_counts:
        mesh = make_mesh(n, device=world_mesh.device)
        vals = (list(_time_sweep(mesh, _tile(problem, n), iters, reps,
                                 backend))
                if mesh.rank is not None else [0.0, 0.0, 0.0])
        rate, kkt, err = _from_rank0(world_mesh, vals)
        if rate1 is None:
            rate1 = rate / n
        results[n] = {"devices": n, "solves_per_s": rate,
                      "efficiency": rate / (n * rate1), "max_kkt": kkt,
                      "mean_wrench_err": err}
    return results


# --------------------------------------------------------------------------
# ranks on one host without torchrun
# --------------------------------------------------------------------------


def _rank_entry(fn, rank, world_size, init_method, device, args, results):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world_size))
    try:
        initialize_multihost(init_method, device=device, backend="gloo")
        results.put((rank, True, fn(rank, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_local_ranks(fn, world_size: int, args=(), *, device,
                    timeout: float = 90.0, tmp_dir: str | None = None) -> list:
    """Run ``fn(rank, *args)`` in ``world_size`` spawned processes that
    form one process group on this host, and return their results in rank
    order. ``fn`` must be importable by name (a module-level function).

    Each process gets torchrun's variables (one host) and joins a gloo
    group through :func:`initialize_multihost` on ``device``
    (a ``FileStore`` in a fresh directory under ``tmp_dir``, so no TCP
    port is involved) before ``fn`` runs. A rank that raises fails the
    call with its traceback; after ``timeout`` seconds the ranks still
    running are killed and the call raises TimeoutError."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = tempfile.mkdtemp(prefix="ranks_", dir=tmp_dir)
    init_method = "file://" + os.path.join(store, "store")
    procs = [ctx.Process(target=_rank_entry,
                         args=(fn, r, world_size, init_method, str(device),
                               tuple(args), results))
             for r in range(world_size)]
    deadline = time.monotonic() + timeout
    out = {}
    try:
        for p in procs:
            p.start()
        while len(out) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(world_size)) - set(out))} "
                                   f"still running after {timeout} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0][0]} exited with code "
                                       f"{dead[0][1]} before reporting")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
            if p.exitcode != 0:
                raise RuntimeError(f"a rank exited with code {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(store, ignore_errors=True)
    return [out[r] for r in range(world_size)]
