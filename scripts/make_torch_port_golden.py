"""Write the JAX reference rollouts that the PyTorch port is held against.

Runs ``quadruped_locomotion_tpu``'s batched closed loop
(``rollout(batched=True, plant=..., qp_backend="xla", terrain=None)``)
over B trot scenarios whose velocity commands are drawn from a seeded
numpy generator, and saves its inputs (model, controller and gait
parameters, the initial batched state, the commands) and its per-tick
telemetry to one compressed ``.npz``. Keys are ``/``-joined field paths,
e.g. ``ls0/sim/robot/base/position`` or ``tel/qp_kkt``.

    JAX_PLATFORMS=cpu python scripts/make_torch_port_golden.py \
        [--plant massless|articulated] [--out PATH] [--batch B] \
        [--ticks T] [--seed 0]

Defaults: the massless plant, B = 8, 25 ticks, written to
``tests/data/torch_port_rollout_golden.npz``; with ``--plant
articulated``, B = 2, 10 ticks, written to
``tests/data/torch_port_articulated_golden.npz``. The first run compiles
the batched rollout on XLA:CPU, which takes a few minutes (the
articulated plant longer).
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np

DATA = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tests", "data")
# plant -> (default output, batch, ticks)
DEFAULTS = {
    "massless": (os.path.join(DATA, "torch_port_rollout_golden.npz"), 8, 25),
    "articulated": (os.path.join(DATA, "torch_port_articulated_golden.npz"),
                    2, 10),
}


def jax_to_numpy(obj):
    """JAX dataclass / NamedTuple tree -> nested dict of numpy arrays,
    keyed by field name (the layout ``quadruped_locomotion_tpu_torch.
    convert`` reads)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: jax_to_numpy(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return {k: jax_to_numpy(v) for k, v in obj._asdict().items()}
    if isinstance(obj, dict):
        return {k: jax_to_numpy(v) for k, v in obj.items()}
    return np.asarray(obj)


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten(v, key + "/"))
        else:
            out[key] = v
    return out


def trot_commands(batch: int, seed: int):
    """Per-scenario trot commands over bench.py's trot ranges:
    vx in [-0.1, 0.4], vy in +-0.1, yaw rate in +-0.3 rad/s."""
    rng = np.random.default_rng(seed)
    vx = rng.uniform(-0.1, 0.4, batch)
    vy = rng.uniform(-0.1, 0.1, batch)
    wz = rng.uniform(-0.3, 0.3, batch)
    lin = np.stack([vx, vy, np.zeros(batch)], axis=1).astype(np.float32)
    return lin, wz.astype(np.float32)


def make_golden(batch: int = 8, ticks: int = 25, seed: int = 0,
                plant: str = "massless") -> dict:
    """Run the JAX reference and return the flat ``{key: array}`` dict."""
    import jax
    import jax.numpy as jnp

    from quadruped_locomotion_tpu.control.locomotion import ControllerParams
    from quadruped_locomotion_tpu.gait.phase import GaitParams
    from quadruped_locomotion_tpu.rollout import closed_loop as cl
    from quadruped_locomotion_tpu.types import RobotModel

    model = RobotModel.simpledog()
    params = ControllerParams.defaults()
    gp = GaitParams.trot_defaults()
    ls_one = cl.init_locomotion(model, gp)
    ls0 = jax.tree_util.tree_map(
        lambda a: jnp.broadcast_to(a, (batch,) + a.shape), ls_one
    )
    lin, wz = trot_commands(batch, seed)
    cmd = cl.Command(linear_velocity=jnp.asarray(lin),
                     yaw_rate=jnp.asarray(wz))

    run = jax.jit(
        lambda ls, c: cl.rollout(
            model, params, gp, ls, c, ticks, batched=True,
            plant=plant, qp_backend="xla", terrain=None,
        )
    )
    _, tel = run(ls0, cmd)
    tree = {
        "model": jax_to_numpy(model),
        "params": jax_to_numpy(params),
        "gait_params": jax_to_numpy(gp),
        "ls0": jax_to_numpy(ls0),
        "cmd": {"linear_velocity": lin, "yaw_rate": wz},
        "tel": jax_to_numpy(tel),
        "meta": {"batch": np.asarray(batch), "ticks": np.asarray(ticks),
                 "seed": np.asarray(seed), "plant": np.asarray(plant)},
    }
    return flatten(tree)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--plant", choices=sorted(DEFAULTS), default="massless")
    ap.add_argument("--out", default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--ticks", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    out, batch, ticks = DEFAULTS[args.plant]
    out = args.out or out
    golden = make_golden(args.batch or batch, args.ticks or ticks, args.seed,
                         plant=args.plant)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez_compressed(out, **golden)
    print(f"wrote {out}: {len(golden)} arrays, {os.path.getsize(out)} bytes")


if __name__ == "__main__":
    main()
