"""Follow a recorded worst QP of the card iterate by iterate: the KKT
residual and objective after 1..15 IPM iterations (each with the endgame
and polish) and over the QP's 63-member ulp ensemble at 15 iterations.

    python scripts/trace_chip_qp.py [rows ...]            # the CUDA kernel and
                                                          # the plain version
    JAX_PLATFORMS=cpu python scripts/trace_chip_qp.py --trace [rows ...]
                                                          # the JAX kernel trace

Rows are those of ``tests/data/torch_port_fd_qp_refs.npz`` (default:
``rollout25_worst sweep_worst``); the ensemble's inputs are
``make_torch_port_references.fd_ulp_ensemble``'s, so the trace's side
matches the committed ``ensemble/`` answers. Prints one JSON line per row
and solver.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import make_torch_port_references as make_refs  # noqa: E402


def _objective(G, g, x):
    x = x.astype(np.float64)
    return 0.5 * np.einsum("bi,bij,bj->b", x, G.astype(np.float64), x) + (
        g.astype(np.float64) * x).sum(-1)


def _problems(rows):
    with np.load(make_refs.FD_QP_OUT) as f:
        p = {k[len("fd_qp/problems/"):]: f[k] for k in f.files
             if k.startswith("fd_qp/problems/")}
    ens = make_refs.fd_ulp_ensemble(p)
    out = {}
    for name in rows:
        i = int(p[f"rows/{name}"][0])
        j = make_refs.FD_ENSEMBLE_ROWS.index(name)
        sl = slice(j * (make_refs.FD_ENSEMBLE - 1),
                   (j + 1) * (make_refs.FD_ENSEMBLE - 1))
        out[name] = ({k: p[k][i:i + 1] for k in "GgDd"},
                     {k: np.concatenate([p[k][i:i + 1], ens[k][sl]])
                      for k in "GgDd"})
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rows", nargs="*",
                    default=["rollout25_worst", "sweep_worst"])
    ap.add_argument("--trace", action="store_true",
                    help="run the JAX kernel trace on the CPU instead")
    args = ap.parse_args()
    if args.trace:
        import jax.numpy as jnp

        from quadruped_locomotion_tpu.ops import qp_pallas

        solvers = {"trace": lambda G, g, D, d, it: [np.asarray(a) for a in
                   qp_pallas.solve_fd_qp_emulated(
                       *(jnp.asarray(a) for a in (G, g, D, d)), iters=it)]}
    else:
        import torch

        from quadruped_locomotion_tpu_torch.ops import fd_qp_kernel as fk

        def on_card(fn):
            def run(G, g, D, d, it):
                t = [torch.as_tensor(a, device="cuda") for a in (G, g, D, d)]
                return [a.cpu().numpy() for a in fn(*t, iters=it)]
            return run

        solvers = {"kernel": on_card(fk.solve_fd_qp),
                   "plain": on_card(fk.solve_fd_qp_plain)}
    for name, (one, ens) in _problems(args.rows).items():
        G, g, D, d = (one[k] for k in "GgDd")
        for solver, solve in solvers.items():
            per_iter = []
            for it in range(1, 16):
                x, _, _, kkt = solve(G, g, D, d, it)
                per_iter.append(dict(iters=it, kkt=float(kkt[0]),
                                     objective=float(_objective(G, g, x)[0])))
            x, _, _, kkt = solve(*(ens[k] for k in "GgDd"), 15)
            obj = _objective(ens["G"], ens["g"], x)
            print(json.dumps(dict(
                row=name, solver=solver, per_iteration=per_iter,
                ensemble_kkt=kkt.tolist(), ensemble_objective=obj.tolist(),
                ensemble_converged=int((kkt < 1e-3).sum()))))


if __name__ == "__main__":
    main()
