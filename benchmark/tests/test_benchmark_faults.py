"""Runs of each cell on the CPU, past the harness's look for a card, with
the timed path sound (``correct`` true) and broken underneath by each
fault the cell can have (``correct`` false). On the CPU the program's QP
runs its plain version; the faults are the ones the comparison must
catch on the card."""

import multiprocessing as mp
import socket
import time

import pytest

import benchmark.run as run
from benchmark.harness import spec
from benchmark.tests import faults

QP_BATCH, DP_BATCH = 64, 32
SEED = 2**31 + 3


def _measure(name, batch, seconds):
    cell = spec.load_cell(name)
    cell.config["batch_per_chip"] = batch
    return run.measure(cell, SEED, seconds, False, "cpu", time.time())


@pytest.mark.parametrize("fault", [None, *faults.QP_FAULTS])
def test_qp_correct_only_when_sound(fault):
    undo = faults.plant_qp(fault) if fault else (lambda: None)
    try:
        line = _measure("qp.balance", QP_BATCH, 0.3)
    finally:
        undo()
    assert line["correct"] is (fault is None), line["checks"]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("fault", [None, *faults.DP_FAULTS])
def test_dp_correct_only_when_sound(fault):
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=faults.rank_main,
                         args=(r, 2, port, fault, DP_BATCH, SEED, results))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        status, line = results.get(timeout=120)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    assert status == "ok", line
    assert all(p.exitcode == 0 for p in procs)
    assert line["correct"] is (fault is None), line["checks"]
