"""Cross-cost-model fuzz harness of the port: every tier against the exact
oracle.

The port of ``tools/fuzz_kernels.py``: random pair batches under
deliberately non-default cost models (cheap gaps, ge > go, wide bands,
overflow-heavy data, both memory tiers, alphabets that defeat 2-bit
packing) run through ``aim_tpu_torch.api.align``, and every pair's score
and CIGAR must equal the port's native oracle byte for byte.  ``CONFIGS``
is the reference's list, all 31 rows; ``random_pairs`` and ``pack`` are
copies of ``tests/util.py``'s (tests hold all three equal).  Each row
prints the tier that served it (K1..K6, "dense" or "host").  Run after any
kernel change, on the GPU:

    python -m aim_tpu_torch.tools.fuzz_kernels [seed0 [n_seeds]]
"""

from __future__ import annotations

import argparse
import random
import sys

import numpy as np

from aim_tpu_torch import native as nat
from aim_tpu_torch.api import align
from aim_tpu_torch.config import AlignConfig
from aim_tpu_torch.ops import kernels
from aim_tpu_torch.ops.common import pack_seqs

BASES = "ACGT"

CONFIGS = [
    ("nw", 48, dict(max_score=12, gap_i=2, gap_d=5, mismatch=1),
     dict(mismatch=1, gap_i=2, gap_d=5)),
    ("nw", 48, dict(max_score=16, gap_i=1, gap_d=1, mismatch=4),
     dict(mismatch=4, gap_i=1, gap_d=1)),
    ("nw", 96, dict(max_score=24, gap_i=3, gap_d=2, mismatch=2,
                    variant="hbm"),
     dict(mismatch=2, gap_i=3, gap_d=2)),
    ("swg", 48, dict(max_score=30, match=0, mismatch=5, gap_o=6, gap_e=2),
     dict(match=0, mismatch=5, gap_o=6, gap_e=2, max_score=30)),
    ("swg", 48, dict(max_score=60, match=0, mismatch=7, gap_o=2, gap_e=3),
     dict(match=0, mismatch=7, gap_o=2, gap_e=3, max_score=60)),
    ("swg", 96, dict(max_score=200, match=-1, mismatch=2, gap_o=3, gap_e=1,
                     variant="hbm"),
     dict(match=-1, mismatch=2, gap_o=3, gap_e=1, max_score=200)),
    ("wfa", 48, dict(max_score=20, mismatch=2, gap_o=3, gap_e=2,
                     adaptive=False),
     dict(mismatch=2, gap_o=3, gap_e=2, max_score=20, adaptive=False)),
    ("wfa", 48, dict(max_score=14, mismatch=5, gap_o=2, gap_e=1,
                     adaptive=True),
     dict(mismatch=5, gap_o=2, gap_e=1, max_score=14, adaptive=True)),
    ("wfa", 96, dict(max_score=40, mismatch=3, gap_o=4, gap_e=1,
                     adaptive=True),
     dict(mismatch=3, gap_o=4, gap_e=1, max_score=40, adaptive=True)),
    # VMEM tier past 128 bp: W16 > 8 exercises the multi-plane next-
    # nonzero-word table (the round-2 3-bit packing broke exactly here)
    ("wfa", 200, dict(max_score=35, mismatch=4, gap_o=2, gap_e=2,
                      adaptive=True),
     dict(mismatch=4, gap_o=2, gap_e=2, max_score=35, adaptive=True)),
    # VMEM-tier admission boundary itself: R=248 -> Rp=256, W16=16 (the
    # 4-bit next-word fields at their encoding maximum + the fidx=16
    # terminator-guarded probe — live only at this geometry; R must be a
    # multiple of 8 per the config contract, and 248 is the largest one
    # that still rounds to Rp=256)
    ("wfa", 248, dict(max_score=30, mismatch=3, gap_o=4, gap_e=1,
                      adaptive=True),
     dict(mismatch=3, gap_o=4, gap_e=1, max_score=30, adaptive=True)),
    # beyond the VMEM tier: exercises the HBM-spill long-read kernel
    # (ring spill, level-walk prefetch, gather extend) under non-default
    # cost models
    ("wfa", 256, dict(max_score=100, mismatch=5, gap_o=2, gap_e=1,
                      adaptive=True, variant="hbm"),
     dict(mismatch=5, gap_o=2, gap_e=1, max_score=100, adaptive=True)),
    ("wfa", 256, dict(max_score=90, mismatch=2, gap_o=1, gap_e=3,
                      variant="hbm"),
     dict(mismatch=2, gap_o=1, gap_e=3, max_score=90, adaptive=False)),
    # 1 kbp-class long-read config (keeps the HBM kernel's larger
    # geometry — NB>1 word blocks — under standing fuzz)
    ("wfa", 1040, dict(max_score=110, mismatch=4, gap_o=3, gap_e=2,
                       adaptive=True, variant="hbm"),
     dict(mismatch=4, gap_o=3, gap_e=2, max_score=110, adaptive=True),
     256),
    ("genasm", 48, dict(max_score=12, mismatch=1, gap_i=1, gap_d=1),
     dict(max_score=12)),
    ("genasm", 96, dict(max_score=20, mismatch=1, gap_i=1, gap_d=1),
     dict(max_score=20)),
    # beyond the NW/SWG VMEM tier: the HBM-streamed long kernel
    # (ops/nwswg_pallas_long.py) — multi-block forward carry + descending
    # walk under non-default cost models, incl. the cheap-gap alias-chain
    # regime that broke the VMEM tier in round 1
    ("nw", 2560, dict(max_score=300, gap_i=2, gap_d=5, mismatch=1,
                      variant="hbm"),
     dict(mismatch=1, gap_i=2, gap_d=5), 256),
    ("nw", 2560, dict(max_score=300, gap_i=1, gap_d=1, mismatch=4,
                      variant="hbm"),
     dict(mismatch=4, gap_i=1, gap_d=1), 256),
    ("swg", 2560, dict(max_score=400, match=0, mismatch=7, gap_o=2, gap_e=3,
                       variant="hbm"),
     dict(match=0, mismatch=7, gap_o=2, gap_e=3, max_score=400), 256),
    # GenASM long tier (ops/genasm_long.py): k past the VMEM bit-vector
    # gate (k >= 27) routes through the unit-cost streamed NW kernel with
    # certified >k overflow rewrites; k=110 leans on the admission bound
    ("genasm", 2560, dict(max_score=60, mismatch=1, gap_i=1, gap_d=1,
                          variant="hbm"),
     dict(max_score=60), 256),
    ("genasm", 2560, dict(max_score=110, mismatch=1, gap_i=1, gap_d=1,
                          variant="hbm"),
     dict(max_score=110), 256),
    # GenASM wide-k (125 < k <= 252 routes the npl=2 / C=127 band
    # statically; this also keeps the wide-band kernel under standing
    # TPU fuzz — api.align's retry tier runs the same kernel)
    ("genasm", 2560, dict(max_score=200, mismatch=1, gap_i=1, gap_d=1,
                          variant="hbm"),
     dict(max_score=200), 256),
    # GenASM plane-count boundary: k=124 is the LAST npl=1 config,
    # k=125 the FIRST static npl=2, k=252 the admission cap
    ("genasm", 2560, dict(max_score=124, mismatch=1, gap_i=1, gap_d=1,
                          variant="hbm"),
     dict(max_score=124), 256),
    ("genasm", 2560, dict(max_score=125, mismatch=1, gap_i=1, gap_d=1,
                          variant="hbm"),
     dict(max_score=125), 256),
    ("genasm", 2560, dict(max_score=252, mismatch=1, gap_i=1, gap_d=1,
                          variant="hbm"),
     dict(max_score=252), 256),
    # ---- >4-symbol alphabet rows (defeat 2-bit packing): byte-compare
    # tiers must stay exact, and api.align's packed_ok re-dispatch must
    # route GenASM-VMEM -> long tier and WFA-long -> XLA tier ----
    ("nw", 96, dict(max_score=24, gap_i=3, gap_d=2, mismatch=2,
                    variant="hbm"),
     dict(mismatch=2, gap_i=3, gap_d=2), 2048, "ACGTN"),
    ("swg", 48, dict(max_score=30, match=0, mismatch=5, gap_o=6, gap_e=2),
     dict(match=0, mismatch=5, gap_o=6, gap_e=2, max_score=30),
     2048, "ACGTN"),
    # WFA VMEM tier, W16 > 8 geometry, unpacked symbol planes
    ("wfa", 200, dict(max_score=35, mismatch=4, gap_o=2, gap_e=2,
                      adaptive=True),
     dict(mismatch=4, gap_o=2, gap_e=2, max_score=35, adaptive=True),
     2048, "ACGTN"),
    # WFA long config: packed_ok=False re-dispatch -> exact XLA tier
    ("wfa", 256, dict(max_score=100, mismatch=5, gap_o=2, gap_e=1,
                      adaptive=True, variant="hbm"),
     dict(mismatch=5, gap_o=2, gap_e=1, max_score=100, adaptive=True),
     256, "ACGTN"),
    # GenASM VMEM-fit config: re-dispatch -> byte-comparing long tier
    ("genasm", 48, dict(max_score=12, mismatch=1, gap_i=1, gap_d=1),
     dict(max_score=12), 2048, "ACGTN"),
    # GenASM long tier, 5-symbol
    ("genasm", 2560, dict(max_score=60, mismatch=1, gap_i=1, gap_d=1,
                          variant="hbm"),
     dict(max_score=60), 256, "ACGTN"),
]


def make_pair(rng: random.Random, plen: int, tlen: int, nerr: int,
              alphabet: str = BASES):
    p = [rng.choice(alphabet) for _ in range(plen)]
    t = (list(p[:tlen]) if tlen <= plen
         else p + [rng.choice(alphabet) for _ in range(tlen - plen)])[:tlen]
    for _ in range(nerr):
        if not t:
            break
        r = rng.random()
        if r < 0.6:
            t[rng.randrange(len(t))] = rng.choice(alphabet)
        elif r < 0.8 and len(t) > 2:
            del t[rng.randrange(len(t))]
        else:
            t.insert(rng.randrange(len(t) + 1), rng.choice(alphabet))
    return "".join(p), "".join(t)


def random_pairs(seed: int, n: int, max_len: int, balanced=True,
                 alphabet: str = BASES):
    """Random pairs; includes plen == tlen+1 (tape-aliasing) cases.
    A >4-symbol alphabet (e.g. "ACGTN") defeats 2-bit packing and
    exercises the byte-comparing device tiers / packed_ok re-dispatch."""
    rng = random.Random(seed)
    pairs = []
    for _ in range(n):
        plen = rng.randrange(3, max_len - 3)
        d = rng.choice([-1, -1, 0, 0, 0, 0, 1, 1] if balanced
                       else [-4, -2, -1, 0, 1, 2, 4])
        tlen = max(1, min(max_len, plen + d))
        pairs.append(make_pair(rng, plen, tlen, rng.randrange(0, 4),
                               alphabet))
    return pairs


def pack(pairs, read_size: int):
    n = len(pairs)
    pats = np.zeros((n, read_size), np.uint8)
    txts = np.zeros((n, read_size), np.uint8)
    pl = np.zeros(n, np.int32)
    tl = np.zeros(n, np.int32)
    for i, (p, t) in enumerate(pairs):
        pats[i, :len(p)] = np.frombuffer(p.encode(), np.uint8)
        txts[i, :len(t)] = np.frombuffer(t.encode(), np.uint8)
        pl[i] = len(p)
        tl[i] = len(t)
    return pats, txts, pl, tl


def row_fields(row):
    """(algo, R, cfg kwargs, oracle kwargs, pairs, alphabet) of a row."""
    algo, R, kw, okw = row[:4]
    n = row[4] if len(row) > 4 else 2048
    alphabet = row[5] if len(row) > 5 else "ACGT"
    return algo, R, kw, okw, n, alphabet


def row_batch(row, seed: int):
    """The row's config and its seeded batch (pats, txts, plens, tlens)."""
    algo, R, kw, _, n, alphabet = row_fields(row)
    pairs = random_pairs(seed=seed, n=n, max_len=R - 8, balanced=False,
                         alphabet=alphabet)
    cfg = AlignConfig(algo=algo, read_size=R, backtrace=True, **kw)
    return cfg, pack(pairs, R)


def tier_of(cfg: AlignConfig, pats, txts, plens, tlens) -> str:
    """The tier ``api.align`` picks for the batch (after packing it)."""
    packed = pack_seqs(pats, txts, plens, tlens, cfg.read_size)[2]
    return kernels.forward_fn(cfg, packed_ok=packed).name


def _oracle(algo, cfg, pats, txts, pl, tl, okw):
    if algo == "genasm":
        return nat.genasm_align(pats, txts, pl, tl, backtrace=True,
                                threads=0, **okw)
    if algo == "nw":
        return nat.nw_align(pats, txts, pl, tl, backtrace=True, threads=0,
                            **okw)
    if algo == "swg":
        return nat.swg_align(pats, txts, pl, tl, backtrace=True,
                             cell_width=cfg.cell_width, threads=0, **okw)
    return nat.wfa_align(pats, txts, pl, tl, backtrace=True, threads=0,
                         **okw)


def run_one(row, seed: int, device="cuda"):
    """One row at one seed: returns (bad pairs, report dict)."""
    algo, R, kw, okw, n, alphabet = row_fields(row)
    cfg, (pats, txts, pl, tl) = row_batch(row, seed)
    tier = tier_of(cfg, pats, txts, pl, tl)
    res = align(pats, txts, pl, tl, cfg, device=device)
    osc, oops, ob, oe = _oracle(algo, cfg, pats, txts, pl, tl, okw)
    score_bad = res.scores != osc
    cigar_bad = np.array([oops[i][ob[i]:oe[i]].tobytes()
                          != res.ops[i][res.begin[i]:res.end[i]].tobytes()
                          for i in range(n)], bool)
    bad = np.nonzero(score_bad | cigar_bad)[0]
    report = dict(algo=algo, read_size=R, kw=kw, alphabet=len(set(alphabet)),
                  seed=seed, pairs=n, tier=tier, fallback=res.n_fallback,
                  retry=res.n_retry, score_bad=int(score_bad.sum()),
                  cigar_bad=int(cigar_bad.sum()),
                  first_bad=int(bad[0]) if len(bad) else None)
    return report["score_bad"] + report["cigar_bad"], report


def fuzz(seeds, device="cuda", out=print):
    """Every row of CONFIGS at every seed; prints a line a row and returns
    (total bad, reports)."""
    total, reports = 0, []
    for r in range(len(CONFIGS)):
        for s in seeds:
            bad, rep = run_one(CONFIGS[r], s, device=device)
            rep["row"] = r
            out(f"row {r} {rep['algo']} R={rep['read_size']} {rep['kw']} "
                f"alpha={rep['alphabet']} seed={s}: tier={rep['tier']} "
                f"fallback={rep['fallback']} retry={rep['retry']} "
                f"score_bad={rep['score_bad']} "
                f"cigar_bad={rep['cigar_bad']}")
            if bad:
                out(f"  FIRST BAD: pair {rep['first_bad']}")
            total += bad
            reports.append(rep)
    out(f"TOTAL BAD: {total}")
    return total, reports


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m aim_tpu_torch.tools."
                                      "fuzz_kernels")
    ap.add_argument("seed0", type=int, nargs="?", default=101)
    ap.add_argument("n_seeds", type=int, nargs="?", default=2)
    a = ap.parse_args(argv)
    total, _ = fuzz(range(a.seed0, a.seed0 + a.n_seeds),
                    out=lambda s: print(s, flush=True))
    return 1 if total else 0


if __name__ == "__main__":
    sys.exit(main())
