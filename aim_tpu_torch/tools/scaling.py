"""Pair-sharded scaling: main-path pairs per second at 1..N cards.

The port's counterpart of ``bench_scaling.py``.  The main path
(WFA-adaptive, 100 bp, e = 1 %, with backtrace) aligns ``n_pairs``
generated pairs through ``api.align`` over 1, 2, 4, ... of the host's
cards: the host clock around the call, which ends in a synchronise of
every card, best of 3 after a first call.  The first call loads the
kernels on each card and allocates the pinned staging buffers; its time
and ``t_load`` are reported apart (``first_s``, ``first_t_load_s``).
``efficiency_vs_1dev`` is the rate over N times the one-card rate.

On a host with one card the shards of a row all run on ``cuda:0``: that
checks the sharded path end to end, but the column is then
``vs_1dev_shared_card``, not a hardware scaling figure, and the output
says so.

    python -m aim_tpu_torch.tools.scaling [n_pairs]

It prints one JSON object and needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from aim_tpu_torch import api, datagen
from aim_tpu_torch.config import derive_config
from aim_tpu_torch.tools import timing

SEED = 0
SHARD_COUNTS = (1, 2, 4, 8, 16)
SHARED_NOTE = ("the shards of every row share one card, so the rate ratio "
               "checks the sharded path's overhead; it is not a hardware "
               "scaling figure")


def rows(n_pairs: int, device_lists, repeats: int = 3) -> list[dict]:
    """Pairs/s of the main path over each device list (the first entry
    the one-device base)."""
    cfg = derive_config("wfa", 100, 0.01, backtrace=True, adaptive=True)
    p, t, pl, tl = datagen.generate_pairs(n_pairs, 100, 0.01,
                                          read_size=cfg.read_size, seed=SEED)
    out = []
    for devs in device_lists:
        t0 = time.perf_counter()
        first = api.align(p, t, pl, tl, cfg, devs)
        first_s = time.perf_counter() - t0
        res = []
        best = timing.best_of(
            lambda: res.append(api.align(p, t, pl, tl, cfg, devs)),
            repeats=repeats, min_anchor_s=0, warmup=False)
        out.append({"devices": len(devs),
                    "cards": len({d for d in devs if d.type == "cuda"}),
                    "pairs_per_s": n_pairs / best, "best_s": best,
                    "t_load_s": min(r.t_load for r in res),
                    "t_kernel_s": min(r.t_kernel for r in res),
                    "t_retrieve_s": min(r.t_retrieve for r in res),
                    "first_s": first_s, "first_t_load_s": first.t_load})
    base = out[0]["pairs_per_s"]
    for row in out:
        if row["cards"] == row["devices"]:
            row["efficiency_vs_1dev"] = row["pairs_per_s"] / (
                base * row["devices"])
        else:
            row["vs_1dev_shared_card"] = row["pairs_per_s"] / base
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("scaling: needs a CUDA device", file=sys.stderr)
        return 2
    from aim_tpu_torch.parallel import devices
    n = int(argv[0]) if argv else 1_000_000
    cards = torch.cuda.device_count()
    shared = cards == 1
    counts = [c for c in SHARD_COUNTS if c <= (4 if shared else cards)]
    lists = [devices(1) * c if shared else devices(c) for c in counts]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    doc = {"metric": "pair-sharded scaling (WFA-adaptive, 100 bp, e=1%, "
                     "backtrace; api.align, host clock)",
           "pairs": n, "gpu": torch.cuda.get_device_name(0),
           "nvidia_smi": smi, "cards": cards, "shared_card": shared,
           "rows": rows(n, lists)}
    if shared:
        doc["note"] = SHARED_NOTE
    print(json.dumps(doc), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
