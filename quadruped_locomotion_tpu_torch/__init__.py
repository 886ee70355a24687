"""PyTorch / CUDA port of ``quadruped_locomotion_tpu`` for NVIDIA Hopper.

It covers the batched closed-loop rollout (flat ground or per-scenario
heightfields, shared or per-scenario trot/pace gait parameters; the
articulated, massless and controller-only plants) with the hand-written
CUDA kernel of the force-distribution QP it runs every control substep,
the QP headline and load-factor solves, the config-5 scenario sweep
(``sweep.py``), and the EKF-estimated closed loop. The JAX package stays
the reference; module names here mirror its modules.

Entry points run on the GPU (``device=None`` means ``"cuda"``) and raise
where CUDA is absent; pass ``device="cpu"`` to run the plain PyTorch
versions on the CPU.
"""
