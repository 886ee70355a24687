"""Command-line operator console of the port (≙ ``quadruped_locomotion_tpu/
api/cli.py``), as subcommands of ``python -m quadruped_locomotion_tpu_torch``:

    list-actions [--collection ID]
    list-collections
    preview ACTION [--ticks N] [--out f.npz]   kinematic preview
    run ACTION [--ticks N]                     the closed loop
    run-collection ID                          a sequence, back to back

``preview`` and ``run`` print the JSON line of the JAX package's console
(``action``, ``ticks``, ``completed``, ``final_base``, then
``final_feet`` / ``max_qp_kkt``) and exit 0 when the schedule completed.
Every command that computes runs on ``--device`` (default ``cuda``;
without CUDA it fails unless given ``--device cpu``). The closed loop's
balance QP is the generic IPM, as in the JAX package: on the card a tick
takes about a second, so ``run`` defaults to the JAX console's 4 s of
planner ticks per step and takes minutes; ``--ticks`` cuts it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _registry(args):
    from .action_loader import ActionRegistry, default_registry

    if getattr(args, "root", None):
        return ActionRegistry(args.root)
    return default_registry()


def _model_and_state(height, device):
    from ..rollout import simulator as simlib
    from ..types import RobotModel

    model = RobotModel.simpledog(device)
    return model, simlib.default_stance_state(model, height=height)


def _compile(reg, action, sim, device):
    return reg.compile(action, sim.robot.base.position,
                       sim.robot.base.quaternion, sim.feet_world,
                       device=device)


def cmd_list_actions(args) -> int:
    for a in _registry(args).list_actions(args.collection):
        print(f"{a.id:>8}  {a.name:<28} {a.description}")
    return 0


def cmd_list_collections(args) -> int:
    for c in _registry(args).list_collections():
        seq = "sequence" if c.is_sequence else "set"
        print(f"{c.id:>8}  {c.name:<28} [{seq}] actions={list(c.action_ids)}")
    return 0


def cmd_preview(args) -> int:
    from ..rollout import preview as pv
    from ..types import full_f32_matmuls

    full_f32_matmuls()
    model, sim = _model_and_state(args.height, args.device)
    sched = _compile(_registry(args), args.action, sim, args.device)
    ticks = args.ticks or int(sched.num_steps * 4.0 / 0.01)
    batch = pv.batch_preview(model, sched, sim.feet_world,
                             sim.robot.base.position,
                             sim.robot.base.quaternion, ticks)
    done = bool(batch.done[-1])
    print(json.dumps({
        "action": args.action, "ticks": ticks, "completed": done,
        "final_base": batch.base_position[-1].cpu().tolist(),
        "final_feet": batch.feet_world[-1].cpu().tolist(),
    }))
    if args.out:
        np.savez(args.out, **{
            k: getattr(batch, k).cpu().numpy()
            for k in ("times", "base_position", "base_quaternion",
                      "joint_positions", "feet_world", "support",
                      "step_index")})
        print(f"state batch saved to {args.out}", file=sys.stderr)
    return 0 if done else 1


def _run_schedule(model, ss0, sched, ticks, device, qp_iters=15):
    from ..control.locomotion import ControllerParams
    from ..rollout import script_loop as sl

    return sl.run_schedule(model, ControllerParams.defaults(device), sched,
                           ss0, ticks, qp_iters=qp_iters, device=device)


def _model_and_script_state(height, device):
    from ..rollout import script_loop as sl
    from ..types import RobotModel

    model = RobotModel.simpledog(device)
    return model, sl.init_script_state(model, height=height, device=device)


def cmd_run(args) -> int:
    model, ss0 = _model_and_script_state(args.height, args.device)
    sched = _compile(_registry(args), args.action, ss0.sim, args.device)
    ticks = args.ticks or int(sched.num_steps * 4.0 / 0.01)
    ssf, tel = _run_schedule(model, ss0, sched, ticks, args.device)
    done = bool(tel["done"][-1])
    print(json.dumps({
        "action": args.action, "ticks": ticks, "completed": done,
        "final_base": ssf.sim.robot.base.position.cpu().tolist(),
        "max_qp_kkt": float(tel["qp_kkt"].max()),
    }))
    return 0 if done else 1


def cmd_run_collection(args) -> int:
    from ..rollout import script_loop as sl

    reg = _registry(args)
    model, ss = _model_and_script_state(args.height, args.device)
    for aid in reg.collections[args.collection].action_ids:
        sched = _compile(reg, aid, ss.sim, args.device)
        ticks = int(sched.num_steps * 4.0 / 0.01)
        ssf, tel = _run_schedule(model, ss, sched, ticks, args.device)
        ss = sl.init_script_state(model, sim=ssf.sim, device=args.device)
        print(f"action {aid}: done={bool(tel['done'][-1])} "
              f"base={ss.sim.robot.base.position.cpu().numpy().round(3).tolist()}",
              file=sys.stderr)
    print(json.dumps({"collection": args.collection, "completed": True}))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="quadruped_locomotion_tpu_torch",
        description="quadruped locomotion console (PyTorch port)")
    p.add_argument("--root", action="append",
                   help="action-library root(s); default = bundled library")
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("list-actions")
    sp.add_argument("--collection", default=None)
    sp.set_defaults(fn=cmd_list_actions)

    sp = sub.add_parser("list-collections")
    sp.set_defaults(fn=cmd_list_collections)

    for name, fn in (("preview", cmd_preview), ("run", cmd_run)):
        sp = sub.add_parser(name)
        sp.add_argument("action")
        sp.add_argument("--ticks", type=int, default=None)
        sp.add_argument("--height", type=float, default=0.38)
        sp.add_argument("--device", default="cuda")
        if name == "preview":
            sp.add_argument("--out", default=None, help="save StateBatch .npz")
        sp.set_defaults(fn=fn)

    sp = sub.add_parser("run-collection")
    sp.add_argument("collection")
    sp.add_argument("--height", type=float, default=0.38)
    sp.add_argument("--device", default="cuda")
    sp.set_defaults(fn=cmd_run_collection)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
