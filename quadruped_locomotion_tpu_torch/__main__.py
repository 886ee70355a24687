"""``python -m quadruped_locomotion_tpu_torch`` → the operator console
(``api/cli.py``)."""

from .api.cli import main

raise SystemExit(main())
