"""Pair sharding across devices (``mesh``) and across processes
(``runner``): the port's counterpart of ``aim_tpu/parallel``."""

from aim_tpu_torch.parallel.mesh import devices, shard_range

__all__ = ["devices", "shard_range"]
