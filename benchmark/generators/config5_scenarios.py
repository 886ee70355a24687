"""The config-5 sweep's scenario axes, drawn from ``--seed`` with numpy:
terrain x gait x velocity, one scenario per row of the batch.

A copy of the draws of ``quadruped_locomotion_tpu_torch/sweep.py::
draw_scenarios`` (and of ``bench.py``'s ``build_scenarios`` before it),
with the ranges in the traffic file's ``params``: at the same seed and
size the two give the same arrays (``benchmark/tests/
test_benchmark_sweep.py``), so the program and the reference take the
same scenarios.

* ``pace`` (B,) bool: scenario i paces where i % ``pace_every`` equals
  ``pace_every`` - 1, and trots otherwise;
* ``vx``, ``vy``, ``wz`` (B,): velocity commands, uniform in the trot's or
  the pace's ranges (both branches of each are drawn, trot's second);
* ``coarse`` (B, n, n) float32: standard normal grids that the program
  upsamples into its heightfields, and ``amp`` (B,) float32: their
  amplitudes in metres, uniform in ``amp_m``, 0 where i % ``flat_every``
  equals ``flat_every`` - 2 (flat ground).
"""

from __future__ import annotations

import numpy as np

from ..harness.traffic import rng as seeded


def generate(params: dict, batch: int, seed: int) -> dict:
    r = seeded(seed)
    idx = np.arange(batch)
    pace = idx % params["pace_every"] == params["pace_every"] - 1
    vel = {}
    for axis in ("vx", "vy", "wz"):
        lo_p, hi_p = params["pace"][axis]
        lo_t, hi_t = params["trot"][axis]
        vel[axis] = np.where(pace, r.uniform(lo_p, hi_p, batch),
                             r.uniform(lo_t, hi_t, batch))
    n = params["coarse_cells"]
    coarse = r.normal(size=(batch, n, n)).astype(np.float32)
    lo, hi = params["amp_m"]
    flat = idx % params["flat_every"] == params["flat_every"] - 2
    amp = np.where(flat, 0.0, r.uniform(lo, hi, batch)).astype(np.float32)
    return {"pace": pace, **vel, "coarse": coarse, "amp": amp}
