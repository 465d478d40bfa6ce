"""The GenASM long tier: unit-cost NW on the streamed kernels K6/K7.

Port of ``aim_tpu/ops/genasm_long.py``.  GenASM's semantics are anchored
to NW at unit costs, so bounded edit distance past the bit-vector tier's
gate (K4) is the unit-cost instance of the streamed NW tier
(``ops/nwswg_long.py``).  The adapter around it is glue, as in the
reference, where it sits outside any kernel: a few elementwise tensor
operations on the records, on the device that holds them.

  * half-empty pairs score plen + tlen (the NW record reports 0); their
    runs (pure I/D tails) are already right;
  * an unflagged score past k becomes the GenASM overflow record: score
    k + 1 and one default 'M' run.  A pair whose score is certified but
    whose CIGAR overflowed the record (bit 8 without bit 9) is rewritten
    too -- the rewrite drops the CIGAR anyway.

Flagged pairs go to the exact host GenASM oracle, after the wider bands of
the retry ladder (api.py).  The primary band grows with k (``_npl``).
"""

from __future__ import annotations

import torch

from aim_tpu_torch.config import ALGO_NW, AlignConfig
from aim_tpu_torch.ops.nw import to_int16
from aim_tpu_torch.ops.nwswg_long import (band_c, device_bytes_per_pair,
                                          long_fit_nwswg, nwswg_forward_long)

OP_M = 0


def _nw_cfg(cfg: AlignConfig) -> AlignConfig:
    return AlignConfig(algo=ALGO_NW, read_size=cfg.read_size,
                       max_score=cfg.max_score, backtrace=cfg.backtrace,
                       gap_i=1, gap_d=1, mismatch=1, variant="hbm")


def _npl(cfg: AlignConfig) -> int:
    """Primary plane count: k <= 124 runs the C = 63 band, k <= 252 the
    C = 127 band, else the C = 255 band."""
    for p in (1, 2):
        if cfg.max_score <= 2 * (band_c(p) - 1):
            return p
    return 4


def long_fit_genasm(cfg: AlignConfig) -> bool:
    """Admission: k <= 2 * (band_c(4) - 1) = 508, and the unit-cost NW
    config inside the streamed tier."""
    return (cfg.max_score <= 2 * (band_c(4) - 1)
            and long_fit_nwswg(_nw_cfg(cfg)))


def bytes_per_pair(cfg: AlignConfig, planes: int | None = None) -> int:
    """Device bytes a pair holds: the unit-cost NW footprint."""
    return device_bytes_per_pair(_nw_cfg(cfg),
                                 _npl(cfg) if planes is None else planes)


def genasm_forward_long(pats, txts, plens, tlens, *, cfg: AlignConfig,
                        packed: bool = False, planes: int | None = None):
    """GenASM long-read forward + walk -> packed_runs [n, NRL] int16, the
    NW/SWG record grammar.  ``planes`` defaults to ``_npl(cfg)``; the retry
    ladder passes wider ones.  CUDA tensors launch K6/K7 (or raise), CPU
    tensors run their plain versions; the rewrite runs where the records
    are."""
    out = nwswg_forward_long(pats, txts, plens, tlens, cfg=_nw_cfg(cfg),
                             packed=packed,
                             planes=_npl(cfg) if planes is None else planes)
    return overflow_rewrite(out, plens, tlens, cfg=cfg)


def overflow_rewrite(rec, plens, tlens, *, cfg: AlignConfig):
    """The adapter on unit-cost NW records (reference :83-109): half-empty
    pairs score plen + tlen, certified scores past k become the k + 1
    overflow record."""
    k = cfg.max_score
    runs = rec.to(torch.int32)
    NRL = runs.shape[1]
    lane = torch.arange(NRL, dtype=torch.int32, device=runs.device)[None, :]
    score = runs[:, 1:2]
    sflag = (runs[:, 0:1] >> 9) & 1
    pl = plens.to(torch.int32)[:, None]
    tl = tlens.to(torch.int32)[:, None]
    half_empty = (pl == 0) ^ (tl == 0)
    score = torch.where(half_empty, pl + tl, score)
    runs = torch.where((lane == 1) & half_empty, score, runs)
    over = (score > k) & (sflag == 0)
    cur = NRL - 2
    cur_enc = (cur & 255) | ((cur >> 8) << 10)
    over_row = torch.where(lane == 0, cur_enc,
                           torch.where(lane == 1, k + 1,
                                       torch.where(lane == NRL - 1,
                                                   (OP_M << 12) | 1, 0)))
    runs = torch.where(over, over_row, runs)
    return to_int16(runs)
