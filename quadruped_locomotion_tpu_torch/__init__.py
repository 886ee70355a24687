"""PyTorch / CUDA port of ``quadruped_locomotion_tpu`` for NVIDIA Hopper.

It covers the batched closed-loop rollout (flat ground or per-scenario
heightfields, shared or per-scenario trot/pace gait parameters; the
articulated, massless and controller-only plants) with the hand-written
CUDA kernel of the force-distribution QP it runs every control substep,
the QP headline and load-factor solves, the config-5 scenario sweep
(``sweep.py``), the EKF-estimated closed loop, and scripted motion: YAML
motion scripts compiled to step schedules (``api/``), the BaseAuto pose
optimization and the step executor (``planning/``), its kinematic
preview and its closed loop (``rollout/preview.py``,
``rollout/script_loop.py``), the 400 Hz runtime (``runtime/``), the
operator API (wire messages, the action server, action classes, the
action loader, markers: ``api/``, ``runtime/action_server.py``), logging
and plots (``utils/logging.py``, ``viz/``), and the console ``python -m
quadruped_locomotion_tpu_torch``. The JAX package stays the reference;
module names here mirror its modules.

Entry points run on the GPU (``device=None`` means ``"cuda"``) and raise
where CUDA is absent; pass ``device="cpu"`` to run the plain PyTorch
versions on the CPU.
"""
