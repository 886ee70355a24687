"""The trace reduction and the per-layer readers, on a made-up trace."""

from types import SimpleNamespace

import pytest

from benchmark.harness import spec
from benchmark.harness.trace import Trace, short_name

US = 1e-6
OPS = [  # (name, start us, end us): a kernel, an all-reduce beside it, a copy
    ("void fd_qp_ipm_kernel<4>(float const*)", 0.0, 1000.0),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(args)", 900.0, 1100.0),
    ("Memcpy DtoH (Device -> Pinned)", 1500.0, 1510.0),
]
TRACE = Trace(OPS, window_s=2000 * US)


def test_busy_time_counts_overlap_once():
    assert TRACE.busy_s() == pytest.approx(1110 * US)
    assert TRACE.seconds() == pytest.approx(1210 * US)
    assert TRACE.count() == 3


def test_breakdown_names_ops_and_gaps():
    b = TRACE.breakdown()
    assert b["device_ops"][0][0].startswith("void fd_qp_ipm_kernel")
    assert b["idle_gaps"] == [[
        "ncclDevKernel_AllReduce_Sum_f32_RING_LL -> Memcpy DtoH",
        pytest.approx(400 * US)]]


def test_short_names_keep_the_functor():
    name = ("void at::native::vectorized_elementwise_kernel<4, "
            "at::native::CUDAFunctor_add<float>, std::array<char*, 3ul> >(int)")
    assert short_name(name) == (
        "at::native::vectorized_elementwise_kernel[CUDAFunctor_add]")


def _run(**counts):
    return SimpleNamespace(trace=TRACE, counts=counts,
                           config={"qp_iters": 15},
                           device_name="NVIDIA H100 80GB HBM3")


def test_readers():
    read = lambda name, run: spec.load_reader(name)(run)  # noqa: E731
    qp = _run(calls=2, batch=16384)
    assert read("qp_entry.kernels_per_call", qp) == 1.5
    assert read("parallel.allreduce_ms", qp) == pytest.approx(0.1)
    assert read("device.idle_pct.qp", qp) == pytest.approx(44.5)
    share = read("fd_qp_ipm_roofline", qp)
    assert 0 < share < 100
    # a reader that finds nothing to read returns None, never 0
    nothing = _run()
    for name in ("fd_qp_ipm_roofline", "qp_entry.kernels_per_call",
                 "device.idle_pct.qp", "parallel.allreduce_ms"):
        assert read(name, nothing) is None, name
    assert read("parallel.allreduce_ms", _run(calls=1, batch=1)) is not None
    lone = SimpleNamespace(trace=Trace(OPS[:1], 2000 * US), counts={"calls": 1},
                           config={}, device_name="x")
    assert read("parallel.allreduce_ms", lone) is None
