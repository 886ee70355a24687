"""The frozen roofline arithmetic equals the program's today."""

import pytest

from benchmark.harness import roofline


@pytest.mark.parametrize("iters", [1, 15, 30])
def test_operation_counts_equal_the_programs(iters):
    from quadruped_locomotion_tpu_torch.ops import fd_qp_kernel as fk

    assert roofline.fd_qp_flops(iters) == fk.fd_qp_flops(iters)
    assert (roofline.weighted_ls_fd_qp_flops(iters)
            == fk.weighted_ls_fd_qp_flops(iters))


@pytest.mark.parametrize("batch", [1, 4096, 16384])
def test_byte_counts_equal_the_programs(batch):
    from quadruped_locomotion_tpu_torch.ops import fd_qp_kernel as fk

    assert roofline.fd_qp_bytes(batch) == fk.fd_qp_bytes(batch)
    assert (roofline.weighted_ls_fd_qp_bytes(batch)
            == fk.weighted_ls_fd_qp_bytes(batch))


def test_the_operation_bound_sets_the_qp_solve():
    flops = roofline.weighted_ls_fd_qp_flops(15) * 16384
    nbytes = roofline.weighted_ls_fd_qp_bytes(16384)
    least = roofline.least_seconds("NVIDIA H100 80GB HBM3", flops, nbytes)
    assert least == pytest.approx(flops / 67e12)
    assert roofline.least_seconds("some other card", flops, nbytes) is None
