"""The benchmark of the PyTorch and CUDA port (``quadruped_locomotion_tpu_torch``).

``benchmark/run.py`` runs one cell of ``BENCHMARK.json`` once; see
``benchmark/README.md``.
"""
