"""Follow a recorded worst QP of the card iterate by iterate: the KKT
residual and objective after 1..15 IPM iterations (each with the endgame
and polish) and over the QP's 63-member ulp ensemble at 15 iterations.

    python scripts/trace_chip_qp.py [rows ...]            # the CUDA kernel and
                                                          # the plain version
    JAX_PLATFORMS=cpu python scripts/trace_chip_qp.py --trace [rows ...]
                                                          # the JAX kernel trace
    python scripts/trace_chip_qp.py --variants [rows ...] # diagnostic builds

``--variants`` builds two more copies of ``csrc/fd_qp_ipm.cu`` into
``quadruped_locomotion_tpu_torch/build/variants/`` (gitignored), both
nvcc runs started together: ``nofma``, with ``-fmad=false`` (no
contraction of a product and a sum into one fused multiply-add), and
``nofma_rn``, which also takes the reciprocal square root correctly
rounded (``__frsqrt_rn`` in place of ``rsqrtf``). They are diagnostic
builds of this script only; the package's kernel is unchanged. For each
build, and for the package's own (``base``), it prints the KKT after
1..15 iterations on the rows, each recorded worst QP's answer at 15
iterations beside ``tests/test_torch_fd_qp.py::check_worst_qp``'s window
of the unperturbed JAX trace (KKT within a factor of 2, objective within
1e-2), and the mean time of one launch at B = 4096 on bench.py's
headline batch (CUDA events).

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


VARIANT_FLAGS = {"nofma": ("-fmad=false",), "nofma_rn": ("-fmad=false",)}
WORST_ROWS = ("rollout_worst", "articulated_worst", "sweep_worst",
              "rollout25_worst")


def build_variants() -> dict:
    """nvcc of every variant at once; returns {name: ctypes library}."""
    import ctypes
    import subprocess

    from quadruped_locomotion_tpu_torch.ops import fd_qp_kernel as fk

    out_dir = fk.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = fk.SOURCE.read_text()
    procs = {}
    for name, flags in VARIANT_FLAGS.items():
        text = src.replace("rsqrtf(", "__frsqrt_rn(") if name == "nofma_rn" \
            else src
        cu = out_dir / f"fd_qp_ipm_{name}.cu"
        cu.write_text(text)
        so = out_dir / f"fd_qp_ipm_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [fk._nvcc(), *fk.NVCC_FLAGS, *flags, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {"base": ctypes.CDLL(str(fk.build_kernel().path))}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        print(json.dumps({"variant": name, "ptxas": fk.ptxas_report(log)}))
        libs[name] = ctypes.CDLL(str(so))
    for lib in libs.values():
        lib.fd_qp_ipm.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.fd_qp_ipm.restype = ctypes.c_int
    return libs


def launcher(lib):
    """A solve through one build's library (the package's launch ABI)."""
    import torch

    def run(G, g, D, d, iters):
        G, g, D, d = (t.contiguous() for t in (G, g, D, d))
        B = G.shape[0]
        x = torch.empty((B, 12), device="cuda")
        s = torch.empty((B, 20), device="cuda")
        z = torch.empty((B, 20), device="cuda")
        kkt = torch.empty((B,), device="cuda")
        rc = lib.fd_qp_ipm(G.data_ptr(), g.data_ptr(), D.data_ptr(),
                           d.data_ptr(), x.data_ptr(), s.data_ptr(),
                           z.data_ptr(), kkt.data_ptr(), B, iters,
                           torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"fd_qp_ipm launch failed ({rc})")
        return x, s, z, kkt
    return run


def run_variants(rows) -> None:
    import torch

    from quadruped_locomotion_tpu_torch import headline
    from quadruped_locomotion_tpu_torch.ops.fd_qp_kernel import form_quadratic
    from quadruped_locomotion_tpu_torch.types import full_f32_matmuls

    full_f32_matmuls()
    with np.load(make_refs.FD_QP_OUT) as f:
        p = {k[len("fd_qp/problems/"):]: f[k] for k in f.files
             if k.startswith("fd_qp/problems/")}
        trace_x, trace_kkt = f["fd_qp/emulated/x"], f["fd_qp/emulated/kkt"]
    A, b, S, W, D, d = headline.build_batch(4096, "cuda")
    G, g = form_quadratic(A, S, W, b)
    big = tuple(t.contiguous() for t in (G, g, D, d))
    cuda = lambda a: torch.as_tensor(a, device="cuda")  # noqa: E731
    for name, lib in build_variants().items():
        solve = launcher(lib)
        res = {"variant": name, "rows": {}}
        for row in WORST_ROWS:
            i = int(p[f"rows/{row}"][0])
            G1, g1, D1, d1 = (cuda(p[k][i:i + 1]) for k in "GgDd")
            x, _, _, kkt = solve(G1, g1, D1, d1, 15)
            x, kkt = x.cpu().numpy(), float(kkt[0])
            obj = _objective(p["G"][i:i + 1], p["g"][i:i + 1], x)[0]
            ref = _objective(p["G"][i:i + 1], p["g"][i:i + 1],
                             trace_x[i:i + 1])[0]
            k0 = float(trace_kkt[i])
            gap = abs(obj - ref) / max(abs(ref), 1e-12)
            r = {"kkt": kkt, "objective": float(obj), "trace_kkt": k0,
                 "trace_objective": float(ref),
                 "meets_window": bool(0.5 * k0 < kkt < 2.0 * k0
                                      and gap < 1e-2)}
            if row in rows:
                r["per_iteration_kkt"] = [
                    float(solve(G1, g1, D1, d1, it)[3][0])
                    for it in range(1, 16)]
            res["rows"][row] = r
        res["ms_b4096"] = headline.cuda_ms(lambda: solve(*big, 15), 20)
        print(json.dumps(res), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rows", nargs="*",
                    default=["rollout25_worst", "sweep_worst"])
    ap.add_argument("--trace", action="store_true",
                    help="run the JAX kernel trace on the CPU instead")
    ap.add_argument("--variants", action="store_true",
                    help="build and run the diagnostic kernel builds")
    args = ap.parse_args()
    if args.variants:
        run_variants(args.rows)
        return
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
