"""The config-5 sweep's first planner tick from the standing start: the
formed QPs that the program's 15-iteration kernel answers wrongly, dumped
with as many answered rightly, so that another solver can be tried on the
same problems off the card.

    python3 benchmark/probes/start_dump.py --batch 32768 --seeds 1 2 3

For each seed it builds the program's config-5 batch
(``sweep.build_scenarios``), runs tick 0 with the kernel, records the four
substeps' formed QPs, solves them to the optimum with the benchmark's
float64 solver (``reference/qp.py``), and marks as wrong the answers more
than 1e-3 (relative) above the optimum or more than 1e-2 N outside the
constraints, as ``start_transient.py`` does. It writes
``<out>/start_dump_<seed>.npz``: per kept instance its substep, index,
G, g, D, d, the kernel's x and KKT residual, the optimum and whether the
kernel's answer was wrong. Needs a CUDA card.
"""

import argparse
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH_DIR.parent))

from benchmark.probes.start_transient import (  # noqa: E402
    GAP, VIOL, _objective, _violation,
)


def dump(batch: int, seed: int, device, out: Path) -> dict:
    import numpy as np
    import torch

    from benchmark.reference import qp as ref_qp
    from quadruped_locomotion_tpu_torch import sweep
    from quadruped_locomotion_tpu_torch.rollout import closed_loop as cl

    sc = sweep.build_scenarios(batch, seed, device)
    _, (_, qps) = cl.planner_tick(
        sc.model, sc.params, sc.gait_params, sc.ls0, sc.command,
        terrain=sc.terrain, plant="articulated", qp_backend="auto",
        telemetry_fn=lambda state, tau, diag, ctx: {
            "G": ctx.G, "g": ctx.g, "D": ctx.D, "d": ctx.d,
            "x": diag.distribution.qp_solution.x,
            "kkt": diag.distribution.qp_solution.kkt_error})
    f64 = ref_qp.Arith("float64")
    rng = np.random.default_rng(seed)
    keep = {k: [] for k in ("substep", "index", "G", "g", "D", "d", "x",
                            "kkt", "x_opt", "wrong")}
    counts = []
    for sub in range(qps["G"].shape[0]):
        G, g, D, d, x, kkt = (qps[k][sub] for k in ("G", "g", "D", "d", "x",
                                                   "kkt"))
        x_opt, _, _ = ref_qp.solve(G, g, D, d, f64)
        f_opt = _objective(G, g, x_opt)
        gap = (_objective(G, g, x) - f_opt).abs() / (1 + f_opt.abs())
        wrong = ((gap > GAP) | (_violation(D, d, x) > VIOL)).cpu().numpy()
        bad = np.flatnonzero(wrong)
        good = rng.choice(np.flatnonzero(~wrong), size=max(len(bad), 8),
                          replace=False)
        idx = np.concatenate([bad, good])
        counts.append(int(len(bad)))
        pick = torch.as_tensor(idx, device=G.device)
        for k, t in (("G", G), ("g", g), ("D", D), ("d", d), ("x", x),
                     ("kkt", kkt), ("x_opt", x_opt)):
            keep[k].append(t[pick].cpu().numpy())
        keep["substep"].append(np.full(len(idx), sub))
        keep["index"].append(idx)
        keep["wrong"].append(wrong[idx])
    out.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out / f"start_dump_{seed}.npz",
                        **{k: np.concatenate(v) for k, v in keep.items()})
    return {"seed": seed, "batch": batch, "wrong_per_substep": counts}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32768)
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--out", type=Path, default=BENCH_DIR / "out")
    args = ap.parse_args()

    import json

    import torch

    if not torch.cuda.is_available():
        print("start_dump.py: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(dump(args.batch, seed, torch.device("cuda"),
                              args.out)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
