"""Devices and contiguous pair ranges for pair-parallel scaling.

The reference scales by sharding contiguous pair blocks across up to
2,500 DPUs (ref: host.c:191 ``nb_reads_per_dpu =
ROUND_UP_MULTIPLE_8(total/nr)``).  ``aim_tpu`` does it with a 1-D
``jax.sharding.Mesh`` over a ``pairs`` axis and ``shard_map``.  In the
port, a list of ``torch.device`` is the sharding: ``api.align(...,
device=[d0, d1, ...])`` splits each chunk into one contiguous block an
entry, in order, launches every block's kernel on its device, and gathers
the records back in pair order.  Pairs are independent, so no collective
is needed.  Across processes, each one takes the contiguous range
``shard_range`` gives it (``parallel.runner``).
"""

from __future__ import annotations

import torch


def devices(n: int | None = None) -> list[torch.device]:
    """The first ``n`` CUDA devices (all of them when ``n`` is None) as a
    list of ``torch.device``, one shard each; raises if there are fewer
    than ``n``, or none."""
    have = torch.cuda.device_count()
    if n is None:
        n = have
    if n < 1 or n > have:
        raise RuntimeError(f"asked for {n} CUDA device(s), this host has "
                           f"{have}")
    return [torch.device("cuda", i) for i in range(n)]


def shard_range(total: int, host_id: int, n_hosts: int) -> tuple[int, int]:
    """Contiguous per-host pair range, mirroring the reference's per-DPU
    block assignment (file order preserved => output idx order preserved)."""
    per = -(-total // n_hosts)
    lo = min(host_id * per, total)
    return lo, min(lo + per, total)
