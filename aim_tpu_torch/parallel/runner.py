"""Multi-process job runner: contiguous pair sharding across processes.

The counterpart of ``aim_tpu/parallel/runner.py``.  The reference host
feeds contiguous pair blocks to DPUs in file order and emits results in
the same order (ref: host.c:191-209, 332-353).  Here each process parses
only its contiguous pair range (global idx = file order preserved),
aligns it on its own device, writes an output part (a temporary file
renamed into place), and process 0 joins the parts in order: an ordered
gather over the filesystem, since the result stream is bulk text.  So no
collective is needed; a ``torch.distributed`` group (gloo), where one is
set up, only holds every process until the joined file exists.

One process a card, under ``torchrun`` (which sets ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and the ``env://`` store):

    torchrun --nproc-per-node 4 -m aim_tpu_torch.parallel.runner \\
        wfa -i pairs.txt -o out -l 100 -e 0.01 -n 1000000 -b -r

or started by hand with ``RANK`` and ``WORLD_SIZE`` set and a file store
every process can reach, ``--init-method file:///shared/store``.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import time

import numpy as np
import torch

from aim_tpu_torch import native
from aim_tpu_torch.config import AlignConfig
from aim_tpu_torch.parallel.mesh import shard_range


def initialize_distributed(init_method: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None):
    """Join the process group (gloo) and return (rank, world size).
    ``num_processes`` and ``process_id`` default to ``WORLD_SIZE`` and
    ``RANK`` (as torchrun sets them), ``init_method`` to ``env://``; a
    one-process run returns (0, 1) and joins nothing."""
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1:
        return 0, 1
    if process_id is None:
        process_id = int(os.environ["RANK"])
    import torch.distributed as dist
    if not dist.is_initialized():
        dist.init_process_group("gloo", init_method=init_method or "env://",
                                world_size=num_processes, rank=process_id)
    return dist.get_rank(), dist.get_world_size()


def local_device(process_id: int) -> torch.device:
    """The card of a process: ``LOCAL_RANK`` (or the process id) modulo
    the host's CUDA devices."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device on this host: pass device= to "
                           "run elsewhere")
    local = int(os.environ.get("LOCAL_RANK", process_id))
    return torch.device("cuda", local % n)


def align_file_multihost(input_path: str, output_path: str, n_reads: int,
                         cfg: AlignConfig, process_id: int = 0,
                         n_processes: int = 1, device=None, verbose=True):
    """Per-process slice of the file-to-file pipeline, on ``device`` (one
    device or a list, as ``api.align`` takes it; ``local_device`` when
    None).

    Returns (n_local, AlignResult).  Process 0 joins the parts in order
    once all exist, and removes them."""
    from aim_tpu_torch.api import align

    # Each process parses only its contiguous block: the shard bounds
    # come from a newline-count pass (no copies), then the range parser
    # packs just [lo, hi) — O(block) host work per process.
    total = native.count_pairs(input_path, n_reads)
    lo, hi = shard_range(total, process_id, n_processes)
    pats, txts, plens, tlens = native.parse_pairs_range(
        input_path, lo, hi - lo, cfg.read_size)
    if device is None:
        device = local_device(process_id)
    res = align(pats, txts, plens, tlens, cfg, device)
    idx = np.arange(lo, hi, dtype=np.int32)  # global pair idx (file order)
    part = output_path + (f".part{process_id}" if n_processes > 1 else "")
    # Write-then-rename so a part file only ever EXISTS complete.
    tmp = part + ".tmp"
    native.emit_output(tmp, idx, res.scores, res.ops, res.begin, res.end,
                       cfg.backtrace)
    os.replace(tmp, part)
    if n_processes > 1 and process_id == 0:
        _concat_parts(output_path, n_processes)
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.barrier()
    if verbose:
        print(f"[host {process_id}] pairs {lo}..{hi} "
              f"load={res.t_load:.3f}s kernel={res.t_kernel:.3f}s "
              f"retrieve={res.t_retrieve:.3f}s fallback={res.n_fallback}")
    return hi - lo, res


def _concat_parts(output_path: str, n_processes: int, timeout_s=600):
    """Ordered gather of the per-process part files.  Parts appear
    atomically (temp-write + os.replace above), so existence == complete."""
    parts = [f"{output_path}.part{p}" for p in range(n_processes)]
    deadline = time.time() + timeout_s
    for p in parts:
        while not os.path.exists(p):
            if time.time() > deadline:
                raise TimeoutError(f"missing output part {p}")
            time.sleep(0.2)
    with open(output_path, "wb") as out:
        for p in parts:
            # Chunked copy: a 10^7-pair backtrace run makes multi-GB
            # parts; keep concatenation constant-memory.
            with open(p, "rb") as f:
                shutil.copyfileobj(f, out, length=8 << 20)
            os.remove(p)


def main(argv=None) -> int:
    """The CLI's alignment arguments, run as this process's share of the
    job (``RANK``/``WORLD_SIZE`` from the environment)."""
    from aim_tpu_torch.cli import build_parser, config_from_args
    from aim_tpu_torch.config import wram_feasible
    ap = argparse.ArgumentParser(prog="aim-tpu-torch-runner", add_help=False)
    ap.add_argument("--init-method", default=None,
                    help="torch.distributed store (default env://)")
    own, rest = ap.parse_known_args(argv)
    args = build_parser().parse_args(rest)
    if args.algo == "gen":
        print("the runner aligns; generate pairs with aim_tpu_torch.cli gen",
              file=sys.stderr)
        return 2
    cfg = config_from_args(args)
    if cfg.variant == "vmem" and not wram_feasible(cfg):
        print("Data doesn't fit in the WRAM (short-read tier); "
              "use --variant hbm for long reads")
        return -1
    rank, world = initialize_distributed(own.init_method)
    try:
        align_file_multihost(args.input, args.output, args.number_reads, cfg,
                             rank, world, verbose=not args.quiet)
    finally:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
