"""Python-type action: the velocity-following continuous trot.

The port's copy of the bundled library's python action (the library's
own file imports the JAX package). The action loader executes it with
``server`` and ``free_gait_action`` in its namespace; it must leave an
``action`` object behind.
"""

from quadruped_locomotion_tpu_torch.api.continuous_actions import VelocityTrotAction

action = VelocityTrotAction(server, velocity=(0.12, 0.0))  # noqa: F821
