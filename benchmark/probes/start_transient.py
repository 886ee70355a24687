"""The config-5 sweep's first planner tick from the standing start, solved
by the program's QP kernel and by its plain version, against the float64
optimum: the look behind leaving the sweep out of ``BENCHMARK.json``.

    python3 benchmark/probes/start_transient.py --batch 32768 --seeds 1 2 3 \
        --more-iters 30 50

For each seed it builds the program's config-5 batch
(``sweep.build_scenarios``), runs tick 0 with ``qp_backend="kernel"`` and
records the four substeps' formed QPs, then solves those same QPs with the
kernel twice (is it repeatable?), with the plain version, with the kernel
at each of ``--more-iters`` interior-point iterations (the configuration
states 15), and with the benchmark's float64 solver
(``reference/qp.py``). Per backend it reports
the instances whose answer stands more than 1e-3 (relative) above the
optimum or outside the constraints by more than 1e-2 N, the largest such
gap and violation, and the program's own KKT residual; and the largest
gap between the joint rates after tick 0 run with the kernel and with the
plain version. One JSON line per seed, on standard output and in
``benchmark/out/start_transient.jsonl``. Needs a CUDA card.
"""

import argparse
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH_DIR.parent))

GAP, VIOL = 1e-3, 1e-2  # what counts as a wrong answer


def _objective(G, g, x):
    x = x.double()
    return 0.5 * (x * (G.double() @ x.unsqueeze(-1)).squeeze(-1)).sum(-1) + (
        g.double() * x).sum(-1)


def _violation(D, d, x):
    slack = (D.double() @ x.double().unsqueeze(-1)).squeeze(-1) - d.double()
    return (-slack).clamp(min=0).amax(-1)


def probe(batch: int, seed: int, device, more_iters=()) -> dict:
    import torch

    from benchmark.reference import qp as ref_qp
    from quadruped_locomotion_tpu_torch import sweep
    from quadruped_locomotion_tpu_torch.control.force_distribution import (
        solve_formed_qp_batched,
    )
    from quadruped_locomotion_tpu_torch.rollout import closed_loop as cl

    sc = sweep.build_scenarios(batch, seed, device)

    def tick(backend, record=False):
        tel = (lambda state, tau, diag, ctx: {"G": ctx.G, "g": ctx.g,
                                              "D": ctx.D, "d": ctx.d}
               ) if record else None
        out = cl.planner_tick(sc.model, sc.params, sc.gait_params, sc.ls0,
                              sc.command, terrain=sc.terrain,
                              plant="articulated", qp_backend=backend,
                              telemetry_fn=tel)
        return out[0], (out[1][1] if record else None)

    ls_kernel, qps = tick("kernel", record=True)
    ls_plain, _ = tick("plain")
    qd_gap = float((ls_kernel.sim.robot.qd - ls_plain.sim.robot.qd).abs().max())

    f64 = ref_qp.Arith("float64")
    runs = {"kernel": ("kernel", 15), "kernel_again": ("kernel", 15),
            "plain": ("plain", 15),
            **{f"kernel_{n}_iters": ("kernel", n) for n in more_iters}}
    rows = {name: [] for name in runs}
    ref_kkt = []  # the float64 solver's largest scaled KKT residual
    for sub in range(qps["G"].shape[0]):
        G, g, D, d = (qps[k][sub] for k in ("G", "g", "D", "d"))
        x_opt, _, kkt_opt = ref_qp.solve(G, g, D, d, f64)
        f_opt = _objective(G, g, x_opt)
        ref_kkt.append(float(kkt_opt.max()))
        for name, (backend, iters) in runs.items():
            sol = solve_formed_qp_batched(G, g, D, d, iters=iters,
                                          backend=backend)
            gap = (_objective(G, g, sol.x) - f_opt).abs() / (1 + f_opt.abs())
            viol = _violation(D, d, sol.x)
            rows[name].append({
                "wrong": int(((gap > GAP) | (viol > VIOL)).sum()),
                "gap_max": float(gap.max()), "viol_max": float(viol.max()),
                "kkt_max": float(sol.kkt_error.max()),
                "x": sol.x})
    same = all(torch.equal(a["x"], b["x"])
               for a, b in zip(rows["kernel"], rows["kernel_again"]))
    out = {"seed": seed, "batch": batch, "kernel_repeats_exactly": same,
           "joint_qd_gap_kernel_vs_plain": qd_gap,
           "reference_kkt_max": ref_kkt}
    for name in rows:
        if name == "kernel_again":
            continue
        out[name] = [{k: v for k, v in r.items() if k != "x"}
                     for r in rows[name]]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32768)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--more-iters", type=int, nargs="*", default=[])
    ap.add_argument("--out", type=Path, default=BENCH_DIR / "out")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("start_transient.py: no CUDA card", file=sys.stderr)
        return 2
    args.out.mkdir(parents=True, exist_ok=True)
    for seed in args.seeds:
        line = json.dumps(probe(args.batch, seed, torch.device("cuda"),
                                args.more_iters))
        print(line, flush=True)
        with (args.out / "start_transient.jsonl").open("a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
