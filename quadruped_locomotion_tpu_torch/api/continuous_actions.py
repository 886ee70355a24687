"""Concrete continuous actions: the feedback-driven velocity-following
trot (≙ ``quadruped_locomotion_tpu/api/continuous_actions.py``).

:class:`VelocityTrotAction` sends one trot half-cycle of ``ExecuteSteps``
goals at a time and uses :class:`~.action.TriggerOnFeedback` (queue
nearly drained and the step's phase past a threshold) to append the next:
the feedback-driven continuation the reference's action framework
(ContinuousAction + TriggerOnFeedback) was built for.
"""

from __future__ import annotations

import numpy as np

from .action import ActionState, ContinuousAction, TriggerOnFeedback

LEG_NAMES = ("LF_LEG", "RF_LEG", "RH_LEG", "LH_LEG")
# foot_print-frame neutral stance (kinematic hips ±0.42 / ±0.175 over
# the default stance, see gait_generator.raibert_footholds notes)
NOMINAL_XY = ((0.42, 0.175), (0.42, -0.175), (-0.42, -0.175), (-0.42, 0.175))
DIAGONALS = ((0, 2), (1, 3))  # LF+RH, then RF+LH (trot exchange order)


class VelocityTrotAction(ContinuousAction):
    """Velocity-following trot as a continuous action object.

    Every goal is one half-cycle: a step swinging one diagonal pair with
    ``base_auto`` support adaptation, footholds displaced by
    0.5·t_cycle·v in the foot_print frame. ``on_feedback`` appends the
    next half-cycle when the trigger fires, alternating diagonals, until
    :meth:`halt` — the trot then parks IDLE at the end of the current
    goal (a clean stop at a full support phase, like the reference's
    gait switch-off leaving a trailing base_auto).
    """

    def __init__(
        self,
        server,
        velocity=(0.15, 0.0),
        t_swing: float = 0.45,
        height: float = 0.38,
        profile_height: float = 0.10,
        trigger: TriggerOnFeedback | None = None,
    ):
        super().__init__(server)
        self.velocity = np.asarray(velocity, float)
        self.t_swing = t_swing
        self.height = height
        self.profile_height = profile_height
        self.trigger = trigger or TriggerOnFeedback(1, 0.6)
        self.running = False
        self._pair = 0
        self.cycles_sent = 0

    # -- goal generation -------------------------------------------------

    def set_velocity(self, velocity) -> None:
        """Live command update (≙ /cmd_vel into the gait client)."""
        self.velocity = np.asarray(velocity, float)

    def _half_cycle_doc(self) -> dict:
        v = self.velocity
        step_len = 0.5 * (2.0 * self.t_swing) * v  # 0.5·t_cycle·v
        legs = DIAGONALS[self._pair]
        motions = [
            {
                "base_auto": {
                    "height": self.height,
                    "average_linear_velocity": 0.3,
                }
            }
        ]
        for leg in legs:
            x0, y0 = NOMINAL_XY[leg]
            motions.append(
                {
                    "footstep": {
                        "name": LEG_NAMES[leg],
                        "profile_type": "triangle",
                        "profile_height": self.profile_height,
                        "average_velocity": 0.45,
                        "target": {
                            "position": [
                                float(x0 + step_len[0]),
                                float(y0 + step_len[1]),
                                0.0,
                            ]
                        },
                    }
                }
            )
        return {
            "adapt_coordinates": [{"transform": {"source_frame": "foot_print"}}],
            "steps": [{"step": motions}],
        }

    def _send_next(self) -> None:
        self.goal = self._half_cycle_doc()
        self._pair ^= 1
        self.cycles_sent += 1
        self._send_goal()

    # -- lifecycle -------------------------------------------------------

    def start(self) -> None:
        self.running = True
        self._send_next()

    def halt(self) -> None:
        """Stop commanding new cycles; current goal finishes → IDLE."""
        self.running = False

    def on_feedback(self, feedback) -> None:
        if not self.running:
            return
        # The trigger sees the feedback snapshot; re-check the LIVE
        # queue so one continuation per drain is sent even though the
        # server delivers the same feedback to every in-flight goal of
        # this action (appending bumps the live queue immediately).
        if (
            self.trigger.check(feedback)
            and self.server.queue_size <= self.trigger.n_steps_in_queue
        ):
            self._send_next()

    def _result_callback(self, result) -> None:
        super()._result_callback(result)
        # queue fully drained before the trigger fired (e.g. long stance
        # or paused server): continue from IDLE
        if self.running and self.state == ActionState.IDLE:
            self._send_next()
