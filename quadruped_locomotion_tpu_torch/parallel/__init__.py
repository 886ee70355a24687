"""Data parallelism over the scenario batch on ``torch.distributed`` (≙
``quadruped_locomotion_tpu/parallel/``).

The JAX package runs one controller over n devices with ``shard_map``;
the port runs one process per card. The scenario batch is split into
contiguous blocks in rank order, each rank runs the port's batched paths
on its block (the QP kernel inside every shard on the card), and the
global health metrics ride ``all_reduce`` over the mesh's process group,
so that every rank ends up holding the same metrics.
"""
