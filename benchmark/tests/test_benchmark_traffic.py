"""The traffic generators: the same seed gives the same draws, and at seed
0 they give the program's own QP batch."""

import json

import numpy as np
import pytest
import torch

from benchmark.drivers import fd_qp
from benchmark.harness import spec, traffic

QP = spec.load_cell("qp.balance")
CPU = torch.device("cpu")


@pytest.mark.parametrize("traffic_file", ["qp.balance", "qp.balance.dp4"])
def test_draws_repeat_per_seed_and_differ_between_seeds(traffic_file):
    mix = json.loads(
        (spec.BENCH_DIR / "workloads" / f"{traffic_file}.json").read_text())
    a = traffic.generate(mix, 16, 2**31 + 11)
    b = traffic.generate(mix, 16, 2**31 + 11)
    c = traffic.generate(mix, 16, 5)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)


def test_seed_0_is_the_programs_headline_batch():
    from quadruped_locomotion_tpu_torch import headline

    B = 64
    draws = traffic.generate(QP.traffic, B, 0)
    ours = fd_qp.build(QP.config, draws, CPU)[0]
    for x, y in zip(ours, headline.build_batch(B, CPU)):
        assert torch.equal(x, y)


def test_pool_batches_are_distinct():
    draws = traffic.generate(QP.traffic, 32, 3)
    assert draws.shape == (QP.traffic["params"]["pool"], 32, 3)
    assert len({d.tobytes() for d in draws}) == draws.shape[0]
