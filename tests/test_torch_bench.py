"""The port's bench entry (``python -m quadruped_locomotion_tpu_torch.bench``)
against the repository's ``bench.py``: each mode's JSON line carries the
keys that bench.py prints for that mode (read from bench.py's source, so
bench.py is neither imported nor run), plus ``"device"``.

On the CPU the latency and sweep measurements run end to end on tiny
inputs (B = 1 with 1-tick chunks; an 8-scenario, 1-tick sweep); the
headline and the roofline time the card, so their records are built here
from the same quality block on an 8-instance CPU batch, and their
measurements must raise off the card; ``--scaling`` measures a world of
one on the CPU. The entry itself runs on the card only.
"""

from __future__ import annotations

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from quadruped_locomotion_tpu_torch import bench, headline
from quadruped_locomotion_tpu_torch.ops import fd_qp_kernel as fk

ROOT = Path(__file__).resolve().parent.parent

torch.set_num_threads(1)


def _bench_keys() -> dict[str, set[str]]:
    """{bench.py function name: keys of the dict literal it passes to
    json.dumps, with the headline's ``extras[...]`` keys}."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    out = {}
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        keys = set()
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
                    == "dumps" and node.args
                    and isinstance(node.args[0], ast.Dict)):
                keys |= {k.value for k in node.args[0].keys
                         if isinstance(k, ast.Constant)}
            if (isinstance(node, ast.Subscript) and isinstance(node.ctx, ast.Store)
                    and getattr(node.value, "id", "") == "extras"):
                keys.add(node.slice.value)
        if keys:
            out[fn.name] = keys
    return out


BENCH_KEYS = _bench_keys()


def _check(record: dict, mode: str, device: str = "cpu") -> None:
    want = BENCH_KEYS[mode] | {"device"}
    assert set(record) == want, (set(record) ^ want)
    json.dumps(record)  # the line serialises
    assert record["device"] == device


def _with_device(record: dict, device: str = "cpu") -> dict:
    record["device"] = bench.device_line(device)
    return record


def test_bench_source_has_the_modes():
    assert {"main", "latency_main", "sweep_main", "roofline_main",
            "scaling_main"} <= set(BENCH_KEYS)
    assert {"metric", "value", "unit", "vs_baseline"} <= BENCH_KEYS["latency_main"]


def test_latency_mode_keys():
    lat = bench.latency_measure(1, "cpu", dispatches=1, chunk=1, warmup=1)
    assert lat["launches"] == 0 and lat["device"] == "cpu"
    rec = _with_device(bench.latency_record(lat))
    _check(rec, "latency_main")
    assert rec["value"] == lat["none"]["p99_ms"] > 0
    assert rec["vs_baseline"] == pytest.approx(2.5 / rec["value"])


def test_sweep_mode_keys():
    rec = _with_device(bench.sweep_record(bench.sweep_run(8, 1, "cpu")))
    _check(rec, "sweep_main")
    assert rec["qp_backend"] == "plain" and rec["sweep_batch"] == 8
    assert rec["upright_frac"] == 1.0 and rec["value"] > 0


@pytest.fixture(scope="module")
def cpu_headline():
    """The headline's result fields on an 8-instance CPU batch: the
    quality block and the generic cross-check as headline.measure forms
    them; the timing fields are placeholders (they time the card)."""
    A, b, S, W, D, d = headline.build_batch(8, "cpu")
    x, _, _, kkt = fk.solve_weighted_ls_fd_qp(A, S, b, W, D, d)
    res = dict(solves_per_s=1.0, chain_per_dispatch=headline.CHAIN,
               batch_time_ms=1.0, single_dispatch_solves_per_s=1.0,
               single_dispatch_ms=1.0)
    res.update(headline.quality(A, b, S, W, D, d, x, kkt))
    res.update(headline.generic_gap(A, b, S, W, D, d, x))
    return res


@pytest.mark.parametrize("extras", ["kernel_only", "with_extras"])
def test_headline_mode_keys(cpu_headline, extras):
    if extras == "kernel_only":
        rec = bench.headline_record(cpu_headline, {})
        want = BENCH_KEYS["main"] - {k for k in BENCH_KEYS["main"]
                                     if k.startswith(("latency_", "sweep_"))}
        assert set(rec) == want
    else:
        lat = bench.latency_measure(1, "cpu", dispatches=1, chunk=1, warmup=1)
        sw = bench.sweep_run(8, 1, "cpu")
        extra = {
            "latency_ctrl_p50_ms": lat["none"]["p50_ms"],
            "latency_ctrl_p99_ms": lat["none"]["p99_ms"],
            "latency_with_plant_p99_ms": lat["articulated"]["p99_ms"],
            "latency_per_dispatch_p50_ms": lat["per_dispatch_p50_ms"],
            "sweep_robots_realtime": sw["rt_factor"],
            "sweep_upright_frac": sw["upright_frac"],
            "sweep_qp_backend": sw["qp_backend"],
            "sweep_batch": sw["batch"], "sweep_ticks": sw["ticks"],
            "sweep_scenario_axes": sw["scenario_axes"]}
        assert set(extra) == {k for k in BENCH_KEYS["main"]
                              if k.startswith(("latency_", "sweep_"))}
        _check(_with_device(bench.headline_record(cpu_headline, extra)), "main")


def test_roofline_mode_keys():
    res = dict(flops_per_solve=float(fk.weighted_ls_fd_qp_flops()),
               solves_per_s=1e6, ms=1.0)
    res["achieved_flop_s"] = res["flops_per_solve"] * res["solves_per_s"]
    rec = _with_device(bench.roofline_record(res))
    _check(rec, "roofline_main")
    assert rec["value"] == pytest.approx(100 * res["achieved_flop_s"] / 67e12)


def test_card_timings_raise_off_the_card():
    with pytest.raises(ValueError, match="times the card"):
        bench.roofline_measure(8, device="cpu")
    with pytest.raises(ValueError, match="times the card"):
        headline.measure(8, device="cpu")


def test_scaling_mode_keys():
    """``--scaling``'s measurement as a world of one on the CPU (an
    in-process gloo group, taken down after): bench.py's scaling keys and
    every count's figures, efficiency 1.0 at one device, a finite KKT."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    try:
        res = bench.scaling_measure(8, iters=10, device="cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert set(res) == {1} and res[1]["efficiency"] == 1.0
    assert res[1]["solves_per_s"] > 0 and np.isfinite(res[1]["max_kkt"])
    rec = _with_device(bench.scaling_record(res))
    assert rec.pop("by_devices") == [res[1]]  # every count's figures
    _check(rec, "scaling_main")
    assert rec["value"] == 1.0 and rec["vs_baseline"] == pytest.approx(1 / 0.85)


@pytest.mark.parametrize("argv", [["8"], ["--roofline", "8"], ["--sweep", "8"],
                                  ["--latency", "25"], ["--scaling", "8"]])
def test_every_mode_needs_the_card(monkeypatch, capsys, argv):
    """The entry runs on the card and raises without it; it prints no
    JSON line then."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(argv)
    assert capsys.readouterr().out == ""
