"""Traffic generators: the inputs of a run, drawn from ``--seed`` with
numpy. A traffic file names its generator and gives its parameters; the
program and the reference receive the same draws.

``stance_pool`` copies the draws of
``quadruped_locomotion_tpu_torch/headline.py::build_batch`` (commit
8388f9c) for a pool of batches: at seed 0 and the same size its first
batch is the headline's. A generator this file does not hold is the
``generate(params, batch, seed)`` of ``benchmark/generators/<name>.py``.
"""

from __future__ import annotations

import importlib

import numpy as np


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    """The generator of ``seed`` (stream 0: the inputs; others: the
    harness's own choices, such as which answers it checks)."""
    if seed < 0:
        raise ValueError(f"--seed must be a whole number >= 0, got {seed}")
    return np.random.default_rng(seed if stream == 0 else [seed, stream])


def stance_pool(params: dict, batch: int, seed: int) -> np.ndarray:
    """(pool, batch, 3) base displacements of standing-balance QPs, uniform
    in ``displacement_m``; the pool's batches follow one another in the
    draw, so batch 0 at seed 0 is the headline's."""
    r = rng(seed)
    lo, hi = params["displacement_m"]
    pool = params["pool"]
    return r.uniform(lo, hi, size=(pool * batch, 3)).reshape(pool, batch, 3)


GENERATORS = {"stance_pool": stance_pool}


def generate(traffic: dict, batch: int, seed: int):
    """The draws of a traffic file's generator."""
    name = traffic["generator"]
    gen = GENERATORS.get(name) or importlib.import_module(
        f"benchmark.generators.{name}").generate
    return gen(traffic["params"], batch, seed)
