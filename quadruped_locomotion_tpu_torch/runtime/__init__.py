"""Runtime layer (≙ ``quadruped_locomotion_tpu/runtime/``): the hardware
abstraction and its wire layouts (:mod:`.hal`), the shared-memory
transport (:mod:`.shm`), the controller manager (:mod:`.manager`) with its
ticks captured as CUDA graphs (:mod:`.graph`), and the two-process
realtime measurement (:mod:`.realtime_bench`)."""

from . import hal, manager  # noqa: F401
