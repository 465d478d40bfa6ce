"""Dry run of the sharded path: a small seeded batch over N shards.

The port's counterpart of ``__graft_entry__.dryrun_multichip``.  For each
family (WFA-adaptive, NW, SWG and GenASM at 100 bp, with backtrace), a
seeded batch runs through ``api.align`` over N shards, then over one, and
is checked: the two output files byte-equal, and equal to the exact
oracle's.  The chunk is cut so that the batch spans several chunks and
its tail leaves blocks short or empty.  The shards go to the first N
cards, or all to ``cuda:0`` where the host has fewer (as ``aim_tpu``'s
dry run runs on a virtual mesh).

    python -m aim_tpu_torch.tools.dryrun_multichip [N]

It prints one JSON line a family and raises on any difference.  It needs
a CUDA device; ``dryrun(n, device="cpu")`` runs the plain kernel versions
(the tests do).
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np
import torch

from aim_tpu_torch import api, datagen, native
from aim_tpu_torch.config import derive_config
from aim_tpu_torch.ops import kernels
from aim_tpu_torch.ops.common import pack_seqs

SEED = 7
FAMILIES = ("wfa", "nw", "swg", "genasm")


def shard_devices(n: int, device=None) -> list[torch.device]:
    """``n`` shards: each on ``device`` when given, else one a card on the
    first ``n`` cards, or all on ``cuda:0`` where there are fewer."""
    if device is not None:
        return [torch.device(device)] * n
    from aim_tpu_torch.parallel import devices
    if torch.cuda.device_count() >= n:
        return devices(n)
    return devices(1) * n


def _emit(path, res, backtrace):
    native.emit_output(path, np.arange(len(res.scores), dtype=np.int32),
                       res.scores, res.ops, res.begin, res.end, backtrace)
    with open(path, "rb") as f:
        return f.read()


def dryrun(n_shards: int, device=None, n_pairs: int = 900,
           batch_pairs: int = 256) -> list[dict]:
    """One report a family; raises AssertionError where the sharded
    output differs from one shard's or the oracle's."""
    devs = shard_devices(n_shards, device)
    reports = []
    with tempfile.TemporaryDirectory(prefix="aim_dryrun_") as tmp:
        for algo in FAMILIES:
            cfg = derive_config(algo, 100, 0.01, backtrace=True,
                                adaptive=algo == "wfa")
            cfg = cfg.replace(batch_pairs=batch_pairs)
            p, t, pl, tl = datagen.generate_pairs(
                n_pairs, 100, 0.01, read_size=cfg.read_size, seed=SEED)
            sharded = api.align(p, t, pl, tl, cfg, devs)
            one = api.align(p, t, pl, tl, cfg, devs[:1])
            osc, oops, ob, oe = (native.wfa_align(
                p, t, pl, tl, mismatch=cfg.mismatch, gap_o=cfg.gap_o,
                gap_e=cfg.gap_e, max_score=cfg.max_score, adaptive=True,
                backtrace=True) if algo == "wfa"
                else api._oracle_align(p, t, pl, tl, cfg))
            oracle = api.AlignResult(osc, oops, ob, oe)
            files = {k: _emit(os.path.join(tmp, k), r, True) for k, r in
                     (("sharded", sharded), ("one", one),
                      ("oracle", oracle))}
            packed = pack_seqs(p, t, pl, tl, cfg.read_size)[2]
            rep = {"algo": algo, "pairs": n_pairs, "shards": n_shards,
                   "devices": sorted({str(d) for d in devs}),
                   "tier": kernels.forward_fn(cfg, packed_ok=packed).name,
                   "chunk_pairs": api._plan_bs(cfg, n_pairs, devs, packed),
                   "equal_one_shard": files["sharded"] == files["one"],
                   "equal_oracle": files["sharded"] == files["oracle"],
                   "fallback": sharded.n_fallback, "retry": sharded.n_retry}
            reports.append(rep)
            if not (rep["equal_one_shard"] and rep["equal_oracle"]):
                raise AssertionError(f"dryrun_multichip: {rep}")
    return reports


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("dryrun_multichip: needs a CUDA device", file=sys.stderr)
        return 2
    n = int(argv[0]) if argv else max(torch.cuda.device_count(), 4)
    for rep in dryrun(n):
        rep["gpu"] = torch.cuda.get_device_name(0)
        print(json.dumps(rep), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
