"""Execution-control runtime: the free_gait action server (≙
``quadruped_locomotion_tpu/runtime/action_server.py``).

The executor is the scripted closed loop's planner tick
(:func:`..rollout.script_loop.planner_tick`) over a capacity-padded
:class:`~..planning.steps.StepSchedule` held on the device, with a host
``active`` count of live rows. All interactivity is host bookkeeping
between ticks:

* a **goal** compiles to schedule rows on the host (``goal_to_schedule``
  with ``device="cpu"``), which are written into the padded buffer with
  one host-to-device copy per goal (every field packed into one byte
  buffer); the robot pose it is resolved against is read with one
  device-to-host copy;
* **stop** truncates ``active`` and, for ``PREEMPT_IMMEDIATE``, expires
  the current step (≙ ``Executor::stop``'s three preemption modes);
* **pause** feeds ``dt = 0`` ticks: the executor's clock stands still and
  the balance controller keeps stabilizing on its held outputs;
* **feedback** and **results** are derived after each tick from one small
  tensor (step index, done, time in step, step duration, the four legs'
  motions) copied to the host once; the schedule's leg motions and base
  modes are mirrored on the host as the rows are written.

The balance QP is the generic IPM, as in the JAX server (no kernel
launch). A server may start from a recorded state (:meth:`from_snapshot`)
to continue a run that another process (or the JAX server) began.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..api import messages as msg
from ..control.locomotion import ControllerParams
from ..planning import steps as steps_mod
from ..planning.steps import BASE_AUTO, LEG_NONE, StepSchedule
from ..rollout import script_loop as sl
from ..types import (
    LIMB_CONFIGURE, RobotModel, full_f32_matmuls, limb_configure_branches,
    resolve_device,
)

LEG_NAMES = msg.LEG_NAMES
_FIELDS = [f.name for f in dataclasses.fields(StepSchedule)]


@dataclasses.dataclass
class _Goal:
    goal_id: int
    first_row: int  # row index of the goal's first step
    n_steps: int
    done: bool = False
    feedback_cb: Callable[[msg.ExecuteStepsFeedback], None] | None = None
    result_cb: Callable[[msg.ExecuteStepsResult], None] | None = None
    result: msg.ExecuteStepsResult | None = None


def _pack(tensors: list[torch.Tensor]) -> torch.Tensor:
    """Host tensors -> one flat uint8 buffer, each part 8-byte aligned."""
    parts = []
    for t in tensors:
        b = t.contiguous().reshape(-1).view(torch.uint8)
        pad = (-b.numel()) % 8
        parts.append(b)
        if pad:
            parts.append(torch.zeros(pad, dtype=torch.uint8))
    return torch.cat(parts)


def _unpack(flat: torch.Tensor, like: list[torch.Tensor]) -> list[torch.Tensor]:
    """Views of ``flat`` (on any device) shaped and typed as ``like``."""
    out, off = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        out.append(flat[off:off + n].view(t.dtype).reshape(t.shape))
        off += n + (-n) % 8
    return out


class FreeGaitActionServer:
    """Host-side goal server around the scripted closed-loop executor, on
    ``device`` (default CUDA; raises where it is absent)."""

    def __init__(self, model: RobotModel, params: ControllerParams | None = None,
                 capacity: int = 16, height: float = 0.4, qp_iters: int = 15,
                 state: sl.ScriptState | None = None, device=None):
        dev = resolve_device(device)
        full_f32_matmuls()
        self.device = dev
        self.model = model.to(dev)
        self.params = (params or ControllerParams.defaults(dev)).to(dev)
        self.capacity = capacity
        self.qp_iters = qp_iters
        self.state = (state.to(dev) if state is not None else
                      sl.init_script_state(self.model, height=height,
                                           device=dev))
        dtype = self.state.sim.feet_world.dtype
        # padded schedule buffer on the device; rows < active are live.
        # Rows past a new goal are reset to the pad row, as the JAX server
        # rebuilds its buffer.
        self._sched = StepSchedule.create(capacity, dtype, dev)
        self._pad = StepSchedule.create(1, dtype, dev)
        # host mirrors of the buffer's leg motions and base modes
        self._host_lm = np.zeros((capacity, 4), np.int64)
        self._host_bm = np.zeros((capacity,), np.int64)
        self._active = 0
        self.paused = False
        # ≙ Executor preemptionType_, set by each accepted goal
        self.preemption_type = msg.PREEMPT_STEP
        self._goals: list[_Goal] = []
        self._next_goal_id = 0
        self.ticks = 0
        self.last_feedback: msg.ExecuteStepsFeedback | None = None
        self.host_copies = 0  # device-to-host copies made by the server
        self._snap: dict | None = None  # host view of the executor

    # ------------------------------------------------------------------
    # restoring a recorded server
    # ------------------------------------------------------------------

    @classmethod
    def from_snapshot(cls, model: RobotModel, snap: dict,
                      params: ControllerParams | None = None,
                      qp_iters: int = 15, device=None):
        """A server continuing a recorded one. ``snap`` is a nested numpy
        dict (the layout of :meth:`snapshot`): ``state`` (a ScriptState
        tree), ``sched`` (the padded StepSchedule tree), ``active``,
        ``ticks``, ``paused``, ``preemption_type``, ``next_goal_id`` and
        ``goals`` (arrays ``goal_id``, ``first_row``, ``n_steps``,
        ``done``, ``result_status``: -1 where no result came yet). Goals
        come back without callbacks; a caller sets a goal's
        ``feedback_cb`` / ``result_cb`` on ``_goals``."""
        from .. import convert

        dev = resolve_device(device)
        state = convert.from_numpy(sl.ScriptState, snap["state"], dev)
        srv = cls(model, params, capacity=int(
            np.asarray(snap["sched"]["base_mode"]).shape[0]),
            qp_iters=qp_iters, state=state, device=dev)
        srv._sched = convert.from_numpy(StepSchedule, snap["sched"], dev)
        srv._host_lm = np.asarray(snap["sched"]["leg_motion_type"],
                                  np.int64).copy()
        srv._host_bm = np.asarray(snap["sched"]["base_mode"], np.int64).copy()
        srv._active = int(snap["active"])
        srv.ticks = int(snap["ticks"])
        srv.paused = bool(snap["paused"])
        srv.preemption_type = int(snap["preemption_type"])
        srv._next_goal_id = int(snap["next_goal_id"])
        g = snap["goals"]
        for gid, first, n, done, status in zip(
                *(np.asarray(g[k]).reshape(-1).tolist() for k in (
                    "goal_id", "first_row", "n_steps", "done",
                    "result_status"))):
            res = (None if status < 0 else
                   msg.ExecuteStepsResult(status=int(status), goal_id=gid))
            srv._goals.append(_Goal(goal_id=int(gid), first_row=int(first),
                                    n_steps=int(n), done=bool(done),
                                    result=res))
        return srv

    def snapshot(self) -> dict:
        """The server's state as a nested numpy dict (see
        :meth:`from_snapshot`)."""
        from .. import convert

        def col(k, dtype):
            return np.asarray([getattr(g, k) for g in self._goals], dtype)

        return {
            "state": convert.to_numpy(self.state),
            "sched": convert.to_numpy(self._sched),
            "active": np.asarray(self._active),
            "ticks": np.asarray(self.ticks),
            "paused": np.asarray(self.paused),
            "preemption_type": np.asarray(self.preemption_type),
            "next_goal_id": np.asarray(self._next_goal_id),
            "goals": {
                "goal_id": col("goal_id", np.int64),
                "first_row": col("first_row", np.int64),
                "n_steps": col("n_steps", np.int64),
                "done": col("done", bool),
                "result_status": np.asarray(
                    [-1 if g.result is None else g.result.status
                     for g in self._goals], np.int64),
            },
        }

    # ------------------------------------------------------------------
    # the executor as the host sees it
    # ------------------------------------------------------------------

    def _read(self) -> dict:
        """Step index, done, time in step, step duration and the legs'
        motions, copied from the device in one transfer per state."""
        if self._snap is None:
            es = self.state.exec
            f = torch.float64
            flat = torch.cat([
                es.step_index.reshape(1).to(f), es.done.reshape(1).to(f),
                es.time_in_step.reshape(1).to(f),
                es.step_duration.reshape(1).to(f),
                es.leg_motion.reshape(4).to(f)])
            h = flat.cpu().numpy()
            self.host_copies += 1
            self._snap = {"step_index": int(h[0]), "done": bool(h[1]),
                          "time_in_step": float(h[2]),
                          "step_duration": float(h[3]),
                          "leg_motion": h[4:8].astype(np.int64)}
        return self._snap

    @property
    def done(self) -> bool:
        return self._read()["done"]

    @property
    def current_row(self) -> int:
        return self._read()["step_index"]

    @property
    def queue_size(self) -> int:
        """Remaining steps including the current one (≙ StepQueue::size)."""
        if self.done:
            return 0
        return max(0, self._active - max(self.current_row, 0))

    def _set_exec(self, **changes) -> None:
        """Replace executor fields (the caller updates the host view)."""
        self.state = self.state.replace(
            exec=self.state.exec.replace(**changes))

    def _row_is_pure_base_auto(self, row: int) -> bool:
        return bool((self._host_lm[row] == LEG_NONE).all()
                    and self._host_bm[row] == BASE_AUTO)

    def _pad_from(self, lo: int) -> None:
        """Reset rows lo.. of the device buffer (and mirrors) to the pad row."""
        if lo >= self.capacity:
            return
        for k in _FIELDS:
            getattr(self._sched, k)[lo:].copy_(
                getattr(self._pad, k).expand_as(getattr(self._sched, k)[lo:]))
        self._host_lm[lo:] = LEG_NONE
        self._host_bm[lo:] = steps_mod.BASE_NONE

    def _write_rows(self, rows: StepSchedule, lo: int) -> None:
        """Host (CPU) rows -> device buffer rows lo..lo+n: one copy."""
        host = [getattr(rows, k) for k in _FIELDS]
        flat = _pack(host).to(self.device)
        n = rows.num_steps
        for k, part in zip(_FIELDS, _unpack(flat, host)):
            getattr(self._sched, k)[lo:lo + n].copy_(part)
        self._host_lm[lo:lo + n] = rows.leg_motion_type.numpy()
        self._host_bm[lo:lo + n] = rows.base_mode.numpy()

    def _compact(self, need: int) -> None:
        """Drop fully executed rows before the current one to make room."""
        cur = max(self.current_row, 0)
        if self._active + need <= self.capacity or cur == 0:
            return
        n_live = self._active - cur
        for k in _FIELDS:
            t = getattr(self._sched, k)
            t[:n_live].copy_(t[cur:self._active].clone())
        self._host_lm[:n_live] = self._host_lm[cur:self._active].copy()
        self._host_bm[:n_live] = self._host_bm[cur:self._active].copy()
        self._pad_from(n_live)
        self._active = n_live
        es = self.state.exec
        self._set_exec(step_index=es.step_index - cur)
        self._snap["step_index"] -= cur
        for g in self._goals:
            g.first_row -= cur

    def _robot_pose(self):
        """Base position, quaternion and feet (host numpy, one copy)."""
        sim = self.state.sim
        flat = torch.cat([sim.robot.base.position.reshape(-1),
                          sim.robot.base.quaternion.reshape(-1),
                          sim.feet_world.reshape(-1)])
        h = flat.cpu().numpy()
        self.host_copies += 1
        return h[0:3], h[3:7], h[7:19].reshape(4, 3)

    # ------------------------------------------------------------------
    # the action API
    # ------------------------------------------------------------------

    def submit_goal(self, goal: msg.ExecuteStepsGoal, feedback_cb=None,
                    result_cb=None) -> int:
        """Accept an ExecuteStepsGoal (mid-run allowed; ≙ goalCallback).
        Returns a goal id."""
        rows = msg.goal_to_schedule(goal, *self._robot_pose(),
                                    dtype=self._sched.leg_target.dtype,
                                    device="cpu")
        return self.submit_rows(rows, goal.preempt, feedback_cb=feedback_cb,
                                result_cb=result_cb)

    def submit_doc(self, doc: dict, preempt: int = msg.PREEMPT_STEP,
                   feedback_cb=None, result_cb=None) -> int:
        """Accept a motion-script document (the YAML schema) as a goal,
        resolved against the current robot state."""
        from ..api import actions as actions_mod

        rows = actions_mod.build_schedule(doc, *self._robot_pose(),
                                          self._sched.leg_target.dtype, "cpu")
        return self.submit_rows(rows, preempt, feedback_cb=feedback_cb,
                                result_cb=result_cb)

    def submit_rows(self, rows: StepSchedule, preempt: int = msg.PREEMPT_STEP,
                    feedback_cb=None, result_cb=None) -> int:
        """Append compiled schedule rows as a goal (the shared back end of
        :meth:`submit_goal` and the loader services)."""
        rows = rows.to("cpu")
        n_new = rows.num_steps
        # Trailing pure-BaseAuto replacement: if the queue has >= 2 steps
        # and its last (not yet executing) step is a pure base_auto, drop
        # it for a smooth merge into the new goal.
        cur = self.current_row
        if (self.queue_size >= 2 and self._active - 1 > max(cur, 0)
                and self._row_is_pure_base_auto(self._active - 1)):
            last_goal = self._goals[-1] if self._goals else None
            if last_goal is not None and not last_goal.done:
                last_goal.n_steps -= 1
            self._active -= 1

        self._compact(n_new)
        if self._active + n_new > self.capacity:
            raise RuntimeError("schedule buffer overflow")
        was_done = self.done
        self._write_rows(rows, self._active)
        self._pad_from(self._active + n_new)
        self._active += n_new
        # a finished executor re-arms on new rows
        if was_done:
            self._set_exec(done=torch.zeros_like(self.state.exec.done))
            self._snap["done"] = False

        self.preemption_type = preempt
        g = _Goal(goal_id=self._next_goal_id, first_row=self._active - n_new,
                  n_steps=n_new, feedback_cb=feedback_cb, result_cb=result_cb)
        self._next_goal_id += 1
        self._goals.append(g)
        return g.goal_id

    def stop(self) -> None:
        """Stop execution per the stored preemption type (≙
        Executor::stop)."""
        if self.preemption_type == msg.PREEMPT_NO:
            return
        cur = self.current_row
        if self._active == 0 or self.done:
            return
        if self.preemption_type == msg.PREEMPT_STEP:
            # clearNextSteps: keep the current step, drop the rest
            if self.queue_size <= 1:
                return
            self._active = max(cur + 1, 1)
        elif self.preemption_type == msg.PREEMPT_IMMEDIATE:
            # clear(): drop everything including the current step; the
            # executor expires at once and idles on the held state
            self._active = max(cur, 0)
            t = self.state.exec.time_in_step
            self._set_exec(time_in_step=torch.full_like(t, float("inf")))
            self._snap["time_in_step"] = float("inf")
        self._finalize_goals(preempted=True)

    def pause(self, should_pause: bool = True) -> None:
        """≙ Executor::pause."""
        self.paused = should_pause

    # ------------------------------------------------------------------
    # loader / configuration services
    # ------------------------------------------------------------------

    def send_action(self, action_id: str, registry=None,
                    preempt: int = msg.PREEMPT_STEP, feedback_cb=None,
                    result_cb=None) -> int:
        """≙ ``SendAction.srv``: compile a registry motion script against
        the current robot state and queue it. Returns the goal id."""
        from ..api.action_loader import default_registry

        registry = registry or default_registry()
        rows = registry.compile(action_id, *self._robot_pose(), device="cpu")
        return self.submit_rows(rows, preempt, feedback_cb=feedback_cb,
                                result_cb=result_cb)

    def send_action_sequence(self, action_ids, registry=None,
                             preempt: int = msg.PREEMPT_STEP) -> list[int]:
        """≙ ``SendActionSequence.srv``: queue several actions back to
        back, each as its own goal. Accepts a sequence-collection id in
        place of the list."""
        from ..api.action_loader import default_registry

        registry = registry or default_registry()
        if isinstance(action_ids, str):
            action_ids = list(registry.collections[action_ids].action_ids)
        return [self.send_action(a, registry=registry, preempt=preempt)
                for a in action_ids]

    def set_limb_configure(self, configure: str) -> bool:
        """≙ ``SetLimbConfigure.srv``: switch the per-leg IK branches
        ('<<', '<>', '><', '>>') from the next tick on; only the model's
        ``ik_branch`` is replaced. Unknown strings return False (the JAX
        server's behaviour; the reference ignores them)."""
        if configure not in LIMB_CONFIGURE:
            return False
        self.model = self.model.replace(
            ik_branch=limb_configure_branches(configure, self.device))
        return True

    # ------------------------------------------------------------------
    # the runtime loop
    # ------------------------------------------------------------------

    def tick(self) -> msg.ExecuteStepsFeedback | None:
        """One 100 Hz planner tick with its 400 Hz control substeps, then
        results and one feedback publication."""
        dt = 0.0 if self.paused else sl.PLANNER_DT
        self.state, _kkt = sl.planner_tick(
            self.model, self.params, self._sched, self.state,
            qp_iters=self.qp_iters, active_steps=self._active, dt=dt)
        self._snap = None
        self.ticks += 1
        self._finalize_goals()
        fb = self._build_feedback()
        self.last_feedback = fb
        if fb is not None:
            # snapshot: a feedback callback may submit a new goal; goals
            # appended during delivery do not get this tick's feedback
            for g in list(self._goals):
                if not g.done and g.feedback_cb is not None:
                    g.feedback_cb(fb)
        return fb

    def run(self, n_ticks: int) -> None:
        for _ in range(n_ticks):
            self.tick()

    def run_until_done(self, max_ticks: int = 10_000) -> None:
        for _ in range(max_ticks):
            self.tick()
            if self.done:
                return

    # ------------------------------------------------------------------
    # feedback / results
    # ------------------------------------------------------------------

    def _goal(self, goal_id: int) -> _Goal:
        for g in self._goals:
            if g.goal_id == goal_id:
                return g
        raise KeyError(goal_id)

    def _goal_of_row(self, row: int) -> _Goal | None:
        for g in self._goals:
            if g.first_row <= row < g.first_row + g.n_steps:
                return g
        return None

    def _finalize_goals(self, preempted: bool = False) -> None:
        # decide every goal against one snapshot, then fire the callbacks:
        # a result callback may submit a goal, which moves rows
        cur = self.current_row
        done = self.done
        fire: list[_Goal] = []
        for g in self._goals:
            if g.done:
                continue
            last = g.first_row + g.n_steps - 1
            finished = cur > last or (done and cur >= last)
            if preempted and not finished:
                # steps at/after the cut are gone
                if g.first_row + g.n_steps > self._active:
                    g.result = msg.ExecuteStepsResult(
                        status=msg.RESULT_PREEMPTED, goal_id=g.goal_id)
                    g.done = True
            elif finished:
                g.result = msg.ExecuteStepsResult(
                    status=msg.RESULT_SUCCEEDED, goal_id=g.goal_id)
                g.done = True
            if g.done and g.result_cb is not None:
                fire.append(g)
        for g in fire:
            g.result_cb(g.result)

    def _build_feedback(self) -> msg.ExecuteStepsFeedback | None:
        """≙ publishFeedback."""
        h = self._read()
        cur = h["step_index"]
        if cur < 0 or self._active == 0:
            return None
        goal = self._goal_of_row(min(cur, self._active - 1))
        duration = h["step_duration"]
        t = h["time_in_step"]
        phase = 0.0 if duration <= 0 else min(t / duration, 1.0)
        branches: list[str] = []
        if not h["done"]:
            lm = h["leg_motion"]
            branches = [LEG_NAMES[i] for i in range(4) if lm[i] != LEG_NONE]
            row = min(cur, self.capacity - 1)
            if self._host_bm[row] != steps_mod.BASE_NONE:
                branches.append("base")
        status = msg.PROGRESS_PAUSED if self.paused else msg.PROGRESS_EXECUTING
        return msg.ExecuteStepsFeedback(
            step_id=f"step_{cur}",
            step_number=(cur - goal.first_row + 1) if goal else 0,
            number_of_steps_in_goal=goal.n_steps if goal else 0,
            queue_size=self.queue_size,
            status=status,
            duration=duration,
            phase=phase,
            active_branches=branches,
        )

    def result_of(self, goal_id: int) -> msg.ExecuteStepsResult | None:
        for g in self._goals:
            if g.goal_id == goal_id:
                return g.result
        return None

