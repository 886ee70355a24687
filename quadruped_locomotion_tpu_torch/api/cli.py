"""Command-line operator console of the port (≙ ``quadruped_locomotion_tpu/
api/cli.py``), as subcommands of ``python -m quadruped_locomotion_tpu_torch``:

    list-actions [--collection ID]
    list-collections
    preview ACTION [--ticks N] [--out f.npz] [--plot f.png]
    run ACTION [--ticks N] [--plot f.png]      the closed loop
    run-collection ID                          a sequence, back to back
    trot --vx 0.2 --seconds 4 [--plot f.png]   the gait engine's trot
    pace --vx 0.2 --seconds 4 [--plot f.png]   and its pace
    edit [--script FILE]                       foothold / knot markers
    update                                     re-scan the registry

``preview`` and ``run`` print the JSON line of the JAX package's console
(``action``, ``ticks``, ``completed``, ``final_base``, then
``final_feet`` / ``max_qp_kkt``) and exit 0 when the schedule completed.
``trot`` / ``pace`` run the batched closed loop at one scenario
(articulated plant) through its default QP backend, the CUDA kernel on
the card, and print the JAX console's keys (``gait``, ``seconds``,
``cmd``, ``distance``, ``mean_speed``, ``final_height``, ``nan``); they
exit 1 when the base went non-finite. ``edit`` reads marker commands
(:func:`.marker.repl`) from stdin or ``--script`` against a live action
server and prints the goals sent and the final state. ``--plot`` writes
a PNG (``viz/plot.py``).

Every command that computes runs on ``--device`` (default ``cuda``;
without CUDA it fails unless given ``--device cpu``). The scripted closed
loop's balance QP is the generic IPM, as in the JAX package: on the card
a tick takes about two seconds, so ``run`` defaults to the JAX console's
4 s of planner ticks per step and takes minutes; ``--ticks`` cuts it.
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
    if args.plot:
        from ..viz import plot_preview

        plot_preview(batch, args.plot, title=f"preview: {args.action}")
        print(f"preview plot saved to {args.plot}", file=sys.stderr)
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
    if args.plot:
        from ..viz import plot_telemetry

        plot_telemetry(tel, args.plot, title=f"run: {args.action}")
        print(f"telemetry plot saved to {args.plot}", file=sys.stderr)
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


def gait_rollout(gait: str, vx: float, vy: float, wz: float, seconds: float,
                 device=None):
    """The console's trot / pace: the batched closed loop at one scenario
    (articulated plant, default QP backend: the kernel on the card) from
    the gait's standing start, as the JAX console starts it (the init
    table of gait type 0). Returns the telemetry with the scenario axis
    dropped."""
    import torch

    from ..control.locomotion import ControllerParams
    from ..gait.phase import GaitParams
    from ..rollout import closed_loop as cl
    from ..types import RobotModel, resolve_device

    dev = resolve_device(device)
    model = RobotModel.simpledog(dev)
    params = ControllerParams.defaults(dev)
    gp = (GaitParams.pace_defaults(dev) if gait == "pace"
          else GaitParams.trot_defaults(dev))
    ls0 = cl.init_locomotion(model, gp, 1, device=dev)
    cmd = cl.Command(
        linear_velocity=torch.tensor([[vx, vy, 0.0]], dtype=torch.float32,
                                     device=dev),
        yaw_rate=torch.tensor([wz], dtype=torch.float32, device=dev))
    ticks = int(seconds / 0.01)
    _, tel = cl.rollout(model, params, gp, ls0, cmd, ticks, device=dev)
    return {k: v[:, 0] for k, v in tel.items()}


def _gait(args, gait: str) -> int:
    tel = gait_rollout(gait, args.vx, args.vy, args.wz, args.seconds,
                       args.device)
    base = tel["base_position"].cpu().numpy()
    if args.plot:
        from ..viz import plot_telemetry

        plot_telemetry(tel, args.plot, title=f"{gait} vx={args.vx}")
        print(f"telemetry plot saved to {args.plot}", file=sys.stderr)
    dist = np.linalg.norm(base[-1, :2] - base[0, :2])
    out = {
        "gait": gait,
        "seconds": args.seconds,
        "cmd": [args.vx, args.vy, args.wz],
        "distance": float(dist),
        "mean_speed": float(dist / args.seconds),
        "final_height": float(base[-1, 2]),
        "nan": bool(np.isnan(base).any()),
    }
    print(json.dumps(out))
    return 1 if out["nan"] else 0


def cmd_trot(args) -> int:
    return _gait(args, "trot")


def cmd_pace(args) -> int:
    return _gait(args, "pace")


def cmd_edit(args) -> int:
    """Foothold / knot editing over a live action server (the headless
    free_gait_marker): commands from stdin or ``--script``."""
    from .marker import MarkerSession, repl

    session = MarkerSession(height=args.height, device=args.device)
    srv = session.server
    print(session.describe())
    if args.script:
        with open(args.script) as f:
            lines = f.readlines()
    else:
        lines = sys.stdin
    repl(session, lines)
    fb = srv.last_feedback
    print(json.dumps({
        "goals_sent": session.sent_goals,
        "queue_size": srv.queue_size,
        "done": srv.done,
        "final_feet": srv.state.sim.feet_world.cpu().tolist(),
        "last_status": None if fb is None else fb.status,
    }))
    return 0


def cmd_update(args) -> int:
    reg = _registry(args)
    reg.update()
    print(f"registry: {len(reg.actions)} actions, "
          f"{len(reg.collections)} collections")
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
        sp.add_argument("--plot", default=None, help="save PNG plot")
        sp.add_argument("--device", default="cuda")
        if name == "preview":
            sp.add_argument("--out", default=None, help="save StateBatch .npz")
        sp.set_defaults(fn=fn)

    sp = sub.add_parser("run-collection")
    sp.add_argument("collection")
    sp.add_argument("--height", type=float, default=0.38)
    sp.add_argument("--device", default="cuda")
    sp.set_defaults(fn=cmd_run_collection)

    for name, fn in (("trot", cmd_trot), ("pace", cmd_pace)):
        sp = sub.add_parser(name)
        sp.add_argument("--vx", type=float, default=0.2)
        sp.add_argument("--vy", type=float, default=0.0)
        sp.add_argument("--wz", type=float, default=0.0)
        sp.add_argument("--seconds", type=float, default=4.0)
        sp.add_argument("--plot", default=None, help="save PNG plot")
        sp.add_argument("--device", default="cuda")
        sp.set_defaults(fn=fn)

    sp = sub.add_parser("edit")
    sp.add_argument("--height", type=float, default=0.4)
    sp.add_argument("--script", default=None,
                    help="read edit commands from a file instead of stdin")
    sp.add_argument("--device", default="cuda")
    sp.set_defaults(fn=cmd_edit)

    sp = sub.add_parser("update")
    sp.set_defaults(fn=cmd_update)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
