"""The JAX package's kernel trace on the config-5 sweep's tick-0 QPs that
``benchmark/probes/start_dump.py`` dumped from the card: does the
reference solver fail the same QPs as the port's kernel?

    JAX_PLATFORMS=cpu python scripts/start_qps_jax_verdict.py \
        chiprun_out/start_dump_*.npz [--iters 15 30 50]

For each file and iteration count it runs ``qp_pallas.solve_fd_qp_emulated``
(the Pallas kernel's body as eager JAX ops) on the dumped problems and
judges each answer against the dumped float64 optimum, as the dump judged
the card's kernel: wrong = more than 1e-3 (relative) above the optimum or
more than 1e-2 N outside the constraints. Prints one JSON line per file
and iteration count: the instances the card's kernel answered wrongly,
those the trace answers wrongly, and how many of those coincide.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

GAP, VIOL = 1e-3, 1e-2


def _objective(G, g, x):
    return (0.5 * np.einsum("bi,bij,bj->b", x, G, x)
            + np.einsum("bi,bi->b", g, x))


def judge(p, x) -> np.ndarray:
    G, g, D, d = (p[k].astype(np.float64) for k in "GgDd")
    x = x.astype(np.float64)
    f_opt = _objective(G, g, p["x_opt"].astype(np.float64))
    gap = np.abs(_objective(G, g, x) - f_opt) / (1.0 + np.abs(f_opt))
    viol = np.clip(d - np.einsum("bij,bj->bi", D, x), 0.0, None).max(-1)
    return (gap > GAP) | (viol > VIOL)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("files", nargs="+")
    ap.add_argument("--iters", type=int, nargs="*", default=[15])
    args = ap.parse_args()
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    import jax

    jax.config.update("jax_platforms", "cpu")
    from quadruped_locomotion_tpu.ops import qp_pallas

    for path in args.files:
        p = dict(np.load(path))
        card = p["wrong"].astype(bool)
        for iters in args.iters:
            x = np.asarray(qp_pallas.solve_fd_qp_emulated(
                *(p[k] for k in "GgDd"), iters=iters)[0])
            trace = judge(p, x)
            print(json.dumps({
                "file": os.path.basename(path), "iters": iters,
                "instances": int(len(card)),
                "card_kernel_wrong": int(card.sum()),
                "jax_trace_wrong": int(trace.sum()),
                "both_wrong": int((card & trace).sum()),
                "jax_trace_wrong_by_substep": [
                    int((trace & (p["substep"] == s)).sum())
                    for s in range(4)],
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
