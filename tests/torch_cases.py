"""Seeded K1 to K7 input cases shared by the port's CPU tests (against the
JAX kernels) and its GPU tests (against the plain PyTorch versions).
Imports no jax and nothing of the JAX package (configs and generated
pairs come from the port's copies), so the GPU tests run on hosts
without it.
Imported by its top-level name: pytest puts tests/ first on sys.path, and
a ``tests`` package installed elsewhere cannot shadow it then."""

import numpy as np
import torch

from aim_tpu_torch import datagen
from aim_tpu_torch.config import AlignConfig, derive_config
from aim_tpu_torch.ops import common
from util import make_pair, pack, random_pairs

MAIN = derive_config("wfa", 100, 0.01, backtrace=True, adaptive=True)
SAMPLE_N = 1000

CASES = ["r24_adaptive_off", "r24_adaptive_on", "main_bt", "main_nobt",
         "overflow", "packed", "acgtn", "r200_s25", "x5_o2_e1_adaptive",
         "x2_o3_e2"]


def datagen_batch(n, seed):
    return datagen.generate_pairs(n, 100, 0.01, read_size=MAIN.read_size,
                                  seed=seed)


def case(name):
    """(cfg, pats, txts, plens, tlens, packed) of one named case."""
    if name.startswith("r24"):
        cfg = AlignConfig(algo="wfa", read_size=24, max_score=15,
                          backtrace=True, adaptive=name.endswith("on"))
        return (cfg, *pack(random_pairs(seed=17, n=128, max_len=24), 24),
                False)
    if name.startswith("main"):
        cfg = MAIN.replace(backtrace=name.endswith("bt"))
        return (cfg, *datagen_batch(128, seed=1), False)
    if name == "overflow":
        cfg = AlignConfig(algo="wfa", read_size=16, max_score=5,
                          backtrace=True)
        return (cfg, *pack([("AAAAAAAA", "TTTTTTTT")] * 8, 16), False)
    if name == "packed":
        p, t, pl, tl = datagen_batch(128, seed=2)
        pp, pt, ok = common.pack_seqs(p, t, pl, tl, MAIN.read_size)
        assert ok
        return MAIN, pp, pt, pl, tl, True
    if name == "acgtn":
        cfg = AlignConfig(algo="wfa", read_size=96, max_score=40,
                          backtrace=True, adaptive=True)
        pairs = random_pairs(seed=5, n=128, max_len=88, balanced=False,
                             alphabet="ACGTN")
        p, t, pl, tl = pack(pairs, 96)
        assert not common.pack_seqs(p, t, pl, tl, 96)[2]
        return cfg, p, t, pl, tl, False
    if name == "r200_s25":
        cfg = AlignConfig(algo="wfa", read_size=200, max_score=25,
                          backtrace=True, adaptive=True)
        return (cfg, *pack(random_pairs(seed=23, n=128, max_len=196), 200),
                False)
    if name.startswith(("x5", "x2")):
        # non-default cost models (tools/fuzz_kernels.py rows): cheap gaps
        # and a gap extension dearer than the default reach the -10 and
        # NULL+1 branches of the next-score compute
        kw = (dict(max_score=14, mismatch=5, gap_o=2, gap_e=1, adaptive=True)
              if name.startswith("x5") else
              dict(max_score=20, mismatch=2, gap_o=3, gap_e=2,
                   adaptive=False))
        cfg = AlignConfig(algo="wfa", read_size=48, backtrace=True, **kw)
        pairs = random_pairs(seed=101, n=128, max_len=40, balanced=False)
        return (cfg, *pack(pairs, 48), False)
    raise KeyError(name)


def garbage_padded(pats, txts, plens, tlens):
    """Copies whose bytes past each length are all 'C' in both sequences:
    they would extend every match if the extend bounds came from the data
    and not from the lengths ('C' also packs to a nonzero 2-bit code, so
    the packed words differ from zero padding too)."""
    pos = np.arange(pats.shape[1])
    p = np.where(pos < plens[:, None], pats, ord("C")).astype(np.uint8)
    t = np.where(pos < tlens[:, None], txts, ord("C")).astype(np.uint8)
    return p, t


def torch_records(fn, cfg, p, t, pl, tl, packed):
    """fn (wfa2_reference or wfa_forward2) on CPU tensors of numpy input."""
    T = torch.from_numpy
    return fn(T(np.ascontiguousarray(p)), T(np.ascontiguousarray(t)),
              T(np.ascontiguousarray(pl, np.int32)),
              T(np.ascontiguousarray(tl, np.int32)), cfg=cfg,
              packed=packed).numpy()


# ---- K2 (NW) and K3 (SWG) ----

NW_MAIN = derive_config("nw", 100, 0.01, backtrace=True)
SWG_MAIN = derive_config("swg", 100, 0.01, backtrace=True)

NWSWG_CASES = ["nw_main_bt", "nw_main_nobt", "swg_main_bt", "swg_main_nobt",
               "nw_r40_bal_bt", "nw_r40_bal_nobt", "nw_r40_unbal_bt",
               "nw_r40_unbal_nobt", "nw_r40_cheap_gaps", "swg_r40_bal",
               "swg_r40_unbal", "nw_packed", "swg_packed", "nw_acgtn",
               "swg_acgtn", "nw_flag_heavy", "swg_flag_heavy", "nw_edges",
               "swg_edges", "nw_ovf_check", "swg_ovf_check", "swg_int16",
               "nw_l128", "swg_l8", "swg_l32", "swg_l128", "swg_mixed",
               "nw_l8", "nw_l32", "nw_mixed", "nw_r800_global"]

EDGE_PAIRS = [("", ""), ("ACGT", ""), ("", "ACGTAC"), ("A", "A"),
              ("AC", "A"), ("ACG", "A"), ("A" * 100, "A" * 100),
              ("A" * 100, "T" * 100), ("ACGTACGTAC" * 10, "ACGTACGTA" * 10)]


def nwswg_case(name):
    """(cfg, pats, txts, plens, tlens, packed) of one named K2/K3 case."""
    algo = name.split("_")[0]
    main = NW_MAIN if algo == "nw" else SWG_MAIN
    if name.endswith(("main_bt", "main_nobt")):
        cfg = main.replace(backtrace=name.endswith("_bt"))
        return (cfg, *datagen_batch(128, seed=1), False)
    if name.startswith("nw_r40"):
        # tests/test_kernels_pallas.py: balanced or not, with or without
        # backtrace; and the cheap-gap alias-chain regression
        if name.endswith("cheap_gaps"):
            cfg = AlignConfig(algo="nw", read_size=40, max_score=16,
                              backtrace=True, gap_i=1, gap_d=1, mismatch=4)
            pairs = random_pairs(seed=101, n=256, max_len=32, balanced=False)
        else:
            cfg = AlignConfig(algo="nw", read_size=40, max_score=10,
                              backtrace=name.endswith("_bt"), gap_i=2,
                              gap_d=3, mismatch=3)
            pairs = random_pairs(seed=11, n=128, max_len=32,
                                 balanced="_bal_" in name)
        return (cfg, *pack(pairs, 40), False)
    if name.startswith("swg_r40"):
        cfg = AlignConfig(algo="swg", read_size=40, max_score=26,
                          backtrace=True, match=0, mismatch=3, gap_o=4,
                          gap_e=1)
        pairs = random_pairs(seed=23, n=128, max_len=32,
                             balanced=name.endswith("_bal"))
        return (cfg, *pack(pairs, 40), False)
    if name.endswith("packed"):
        p, t, pl, tl = datagen_batch(128, seed=2)
        pp, pt, ok = common.pack_seqs(p, t, pl, tl, main.read_size)
        assert ok
        return main, pp, pt, pl, tl, True
    if name == "nw_acgtn":
        # the R = 96 NW row of tools/fuzz_kernels.py (its `hbm` variant
        # lands on K2: the NW gate ignores the variant), 5 symbols
        cfg = AlignConfig(algo="nw", read_size=96, max_score=24, gap_i=3,
                          gap_d=2, mismatch=2, variant="hbm", backtrace=True)
        pairs = random_pairs(seed=5, n=128, max_len=88, balanced=False,
                             alphabet="ACGTN")
        return (cfg, *pack(pairs, 96), False)
    if name == "swg_acgtn":
        pairs = random_pairs(seed=5, n=128, max_len=104, balanced=False,
                             alphabet="ACGTN")
        return (main, *pack(pairs, main.read_size), False)
    if name.endswith("flag_heavy"):
        # 10 edits on 100 bp: the band flags nearly every pair
        return (main, *datagen.generate_pairs(128, 100, 0.1, read_size=112,
                                              seed=3), False)
    if name.endswith("edges"):
        return (main, *pack(EDGE_PAIRS * 4, main.read_size), False)
    if name == "nw_ovf_check":
        # (2R+2) * 200 > 32767 compiles the int16 range check in
        cfg = NW_MAIN.replace(mismatch=200, gap_i=150, gap_d=150)
        return (cfg, *datagen.generate_pairs(128, 100, 0.05, read_size=112,
                                             seed=4), False)
    if name == "swg_ovf_check":
        # int8-sound and admitted, but stored max + margin = 129 > 127
        cfg = SWG_MAIN.replace(max_score=9)
        return (cfg, *datagen.generate_pairs(128, 100, 0.03, read_size=112,
                                             seed=4), False)
    if name == "swg_int16":
        # tools/fuzz_kernels.py :36-37 costs on the int16-cell variant
        cfg = AlignConfig(algo="swg", read_size=48, max_score=60, match=0,
                          mismatch=7, gap_o=2, gap_e=3, variant="hbm",
                          backtrace=True)
        pairs = random_pairs(seed=7, n=128, max_len=40, balanced=False)
        return (cfg, *pack(pairs, 48), False)
    if name == "nw_l128":
        # unit costs at MAX_SCORE 60: C = 62, a 128-lane band (4 lanes a
        # thread in the CUDA kernel)
        cfg = AlignConfig(algo="nw", read_size=96, max_score=60, gap_i=1,
                          gap_d=1, mismatch=1, backtrace=True)
        pairs = random_pairs(seed=9, n=64, max_len=88, balanced=False)
        return (cfg, *pack(pairs, 96), False)
    # K3's band widths past the 100 bp config's L = 16 (L = 64 is
    # swg_int16): MAX_SCORE 2 gives L = 8 (four pairs a warp in the CUDA
    # kernel), 10 gives L = 32, the int16 cells at 60 give L = 128
    if name == "swg_l8":
        return (SWG_MAIN.replace(max_score=2), *datagen.generate_pairs(
            96, 100, 0.005, read_size=112, seed=6), False)
    if name == "swg_l32":
        return (SWG_MAIN.replace(max_score=10), *datagen.generate_pairs(
            96, 100, 0.02, read_size=112, seed=7), False)
    if name == "swg_l128":
        cfg = AlignConfig(algo="swg", read_size=96, max_score=60, match=0,
                          mismatch=3, gap_o=4, gap_e=1, variant="hbm",
                          backtrace=True)
        pairs = random_pairs(seed=10, n=64, max_len=88, balanced=False)
        return (cfg, *pack(pairs, 96), False)
    if name == "swg_r520_global":
        # int16 cells at L = 16 past 48 KB of planes a block: the planes in
        # the global scratch
        cfg = AlignConfig(algo="swg", read_size=520, max_score=5, match=0,
                          mismatch=3, gap_o=4, gap_e=1, variant="hbm",
                          backtrace=True)
        return (cfg, *datagen.generate_pairs(24, 500, 0.005, read_size=520,
                                             seed=11), False)
    # K2's band widths past the 100 bp config's L = 16: MAX_SCORE 2 gives
    # L = 8 (four pairs a warp in the CUDA kernel), 20 gives L = 32
    if name == "nw_l8":
        return (NW_MAIN.replace(max_score=2), *datagen.generate_pairs(
            96, 100, 0.005, read_size=112, seed=12), False)
    if name == "nw_l32":
        return (NW_MAIN.replace(max_score=20), *datagen.generate_pairs(
            96, 100, 0.02, read_size=112, seed=13), False)
    if name == "nw_r800_global":
        # L = 16 past 48 KB of planes a block: the planes in the global
        # scratch
        cfg = AlignConfig(algo="nw", read_size=800, max_score=8,
                          backtrace=True)
        return (cfg, *datagen.generate_pairs(24, 780, 0.003, read_size=800,
                                             seed=14), False)
    if name in ("swg_mixed", "nw_mixed"):
        # unlike neighbours in one warp: a normal pair next to a flagged
        # one (1 % and 10 % errors interleaved) or an edge pair (empty
        # sequences, full lengths), and 137 pairs, which leave the last
        # warp part-empty
        near = datagen.generate_pairs(64, 100, 0.01, read_size=112, seed=8)
        far = datagen.generate_pairs(64, 100, 0.1, read_size=112, seed=9)
        edges = pack(EDGE_PAIRS, main.read_size)
        return (main, *interleave(near, far, edges), False)
    raise KeyError(name)


def interleave(a, b, c):
    """Rows of three (pats, txts, plens, tlens) batches of equal width,
    alternating a[i] with c[i] while c lasts, then with b[i]; then the
    rows of b that c displaced."""
    na, nc = len(a[2]), len(c[2])
    order = []
    for i in range(na):
        order.append((a, i))
        order.append((c, i) if i < nc else (b, i))
    order += [(b, i) for i in range(min(nc, len(b[2])))]
    return tuple(np.stack([src[f][i] for src, i in order])
                 for f in range(4))


def nwswg_records(cfg, p, t, pl, tl, packed, reference=True):
    """K2/K3 plain version (or wrapper) on CPU tensors of numpy input."""
    from aim_tpu_torch.ops import nw, swg
    mod = nw if cfg.algo == "nw" else swg
    fn = getattr(mod, f"{cfg.algo}_reference" if reference
                 else f"{cfg.algo}_forward")
    return torch_records(fn, cfg, p, t, pl, tl, packed)


# ---- K4 (GenASM) and K5 (WFA long reads) ----

GENASM_MAIN = derive_config("genasm", 100, 0.01, backtrace=True)

GENASM_CASES = ["r32_k12_bt", "r32_k12_nobt", "r16_k5_edges_bt",
                "r16_k5_edges_nobt", "main_bt", "main_nobt", "overflow_bt",
                "overflow_nobt", "r64_k26_bt", "r24_k10_bt", "r112_k5_bt",
                "mixed_bt", "mixed_nobt"]

GENASM_EDGES = [("", "ACG"), ("ACG", ""), ("", ""), ("A", "A"), ("A", "T"),
                ("AC", "A"), ("A", "AC"), ("ACGT", "ACGT"), ("AAAA", "TTTT"),
                ("AAAAAAAA", "TTTTTTTT")] * 2


def genasm_case(name):
    """(cfg, pats, txts, plens, tlens) of one named K4 case, raw bytes
    (the tier takes them 2-bit packed)."""
    bt = name.endswith("_bt")
    if name.startswith("r32"):
        # tests/test_genasm.py: R 32, k 12, 128 random pairs
        cfg = AlignConfig(algo="genasm", read_size=32, max_score=12,
                          backtrace=bt)
        return (cfg, *pack(random_pairs(seed=73, n=128, max_len=24), 32))
    if name.startswith("r16"):
        # tests/test_genasm.py edge pairs, empty sequences included
        cfg = AlignConfig(algo="genasm", read_size=16, max_score=5,
                          backtrace=bt)
        return (cfg, *pack(GENASM_EDGES, 16))
    if name.startswith("main"):
        return (GENASM_MAIN.replace(backtrace=bt),
                *datagen.generate_pairs(64, 100, 0.01, read_size=112,
                                        seed=3))
    if name.startswith("overflow"):
        # 3 edits on 100 bp against k = 2: overflow pairs in the mix
        return (GENASM_MAIN.replace(backtrace=bt),
                *datagen.generate_pairs(64, 100, 0.03, read_size=112,
                                        seed=3))
    if name == "r64_k26_bt":
        # the gate's k edge (k < 27): 81 rows, history past 48 KB a block
        cfg = AlignConfig(algo="genasm", read_size=64, max_score=26,
                          backtrace=True)
        return (cfg, *pack(random_pairs(seed=7, n=64, max_len=60,
                                        balanced=False), 64))
    # the CUDA kernel's paths by rows DW = (k+1) x words: 11 rows with the
    # full history (16 lanes a pair); 24 rows with the windowed history
    # (32 lanes); main_bt is 12 rows windowed, r32_k12 26 rows full,
    # r64_k26 81 rows (one warp a pair)
    if name == "r24_k10_bt":
        cfg = AlignConfig(algo="genasm", read_size=24, max_score=10,
                          backtrace=True)
        return (cfg, *pack(random_pairs(seed=31, n=96, max_len=22,
                                        balanced=False), 24))
    if name == "r112_k5_bt":
        return (GENASM_MAIN.replace(max_score=5),
                *datagen.generate_pairs(48, 100, 0.03, read_size=112,
                                        seed=5))
    if name == "r112_k7_bt":
        # 32 rows with the full history: the global scratch
        return (GENASM_MAIN.replace(max_score=7),
                *datagen.generate_pairs(24, 100, 0.04, read_size=112,
                                        seed=6))
    if name.startswith("mixed"):
        # unlike neighbours in one warp: a normal pair next to an edge
        # pair (empty sequences, overflow) or an overflowing one, walks of
        # different lengths, and 147 pairs (the last warp part-empty)
        main = datagen.generate_pairs(64, 100, 0.01, read_size=112, seed=3)
        over = datagen.generate_pairs(64, 100, 0.05, read_size=112, seed=4)
        edges = pack(GENASM_EDGES, 112)
        rows = interleave(main, over, edges)
        return (GENASM_MAIN.replace(backtrace=bt), *(a[:147] for a in rows))
    raise KeyError(name)


def packed_case(p, t, pl, tl, read_size):
    """The 2-bit packed form of a DNA batch."""
    pp, pt, ok = common.pack_seqs(p, t, pl, tl, read_size)
    assert ok
    return pp, pt


WFA_LONG_CASES = ["r264_s40_ad", "r264_s40_nonad", "r264_s40_nobt",
                  "mixed_r520_s50", "acgtn_r264_s40", "l1000"]


def _long_pairs(R, n, seed=41):
    """tests/test_longread.py::_pairs at any R."""
    import random

    from util import make_pair
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        plen = rng.randrange(150, R - 30)
        tlen = max(1, plen + rng.choice([-1, 0, 0, 1]))
        out.append(make_pair(rng, plen, tlen, rng.randrange(0, 8)))
    return out


def mixed_lengths_batch(R=520, n=16, seed=91):
    """tests/test_longread.py's mixed-length tile: empty, tiny and
    full-length pairs."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    pats = np.zeros((n, R), np.uint8)
    txts = np.zeros((n, R), np.uint8)
    pl = np.zeros(n, np.int32)
    tl = np.zeros(n, np.int32)
    lens = [0, 1, 13, 50, 250, 500]
    for i in range(n):
        lp = lens[i % len(lens)]
        lt = max(0, lp + int(rng.integers(-3, 4))) if lp else 0
        p0 = bases[rng.integers(0, 4, lp)] if lp else np.zeros(0, np.uint8)
        if lt <= lp:
            t0 = p0[:lt].copy()
        else:
            t0 = np.concatenate([p0, bases[rng.integers(0, 4, lt - lp)]])
        if lt:
            mut = rng.random(lt) < 0.02
            t0 = np.where(mut, bases[rng.integers(0, 4, lt)], t0)
        pats[i, :lp] = p0
        txts[i, :lt] = t0
        pl[i] = lp
        tl[i] = lt
    return pats, txts, pl, tl


def wfa_long_case(name):
    """(cfg, pats, txts, plens, tlens) of one named K5 case, raw bytes."""
    if name.startswith("r264"):
        cfg = AlignConfig(algo="wfa", read_size=264, max_score=40,
                          backtrace=not name.endswith("nobt"),
                          adaptive=not name.endswith("nonad"),
                          variant="hbm")
        return (cfg, *pack(_long_pairs(264, 12), 264))
    if name == "mixed_r520_s50":
        cfg = AlignConfig(algo="wfa", read_size=520, max_score=50,
                          backtrace=True, adaptive=True, variant="hbm")
        return (cfg, *mixed_lengths_batch())
    if name == "acgtn_r264_s40":
        cfg = AlignConfig(algo="wfa", read_size=264, max_score=40,
                          backtrace=True, adaptive=True, variant="hbm")
        pairs = random_pairs(seed=5, n=16, max_len=250, balanced=False,
                             alphabet="ACGTN")
        p, t, pl, tl = pack(pairs, 264)
        assert not common.pack_seqs(p, t, pl, tl, 264)[2]
        return (cfg, p, t, pl, tl)
    if name == "l1000":
        cfg = derive_config("wfa", 1000, 0.01, backtrace=True,
                            adaptive=True, variant="hbm")
        return (cfg, *datagen.generate_pairs(16, 1000, 0.01,
                                             read_size=cfg.read_size,
                                             seed=2))
    raise KeyError(name)


# ---- K6 / K7 (the streamed NW/SWG tier) and the GenASM long tier ----

def subs_pair(rng, lp, nsub):
    """tests/test_longread.py::_subs_pair: an equal-length pair differing
    by nsub substitutions (edit distance nsub, no length drift)."""
    bases = "ACGT"
    p = [rng.choice(bases) for _ in range(lp)]
    t = list(p)
    for pos in rng.sample(range(lp), nsub):
        t[pos] = bases[(bases.index(t[pos]) + rng.randrange(1, 4)) % 4]
    return "".join(p), "".join(t)


def burst_subs_pair(rng, lp, d):
    """tests/test_longread.py::_burst_subs_pair: d/3 bursts of three
    substitutions, spaced at least 4 apart."""
    bases = "ACGT"
    p = [rng.choice(bases) for _ in range(lp)]
    t = list(p)
    nb = d // 3
    for i in range(nb):
        start = i * (lp // nb) + rng.randrange(0, max(1, lp // nb - 6))
        for pos in range(start, min(start + 3, lp)):
            t[pos] = bases[(bases.index(t[pos]) + rng.randrange(1, 4)) % 4]
    return "".join(p), "".join(t)


NW_LONG = dict(algo="nw", max_score=300, backtrace=True, gap_i=2, gap_d=3,
               mismatch=3)
SWG_LONG = dict(algo="swg", max_score=400, backtrace=True, match=0,
                mismatch=3, gap_o=4, gap_e=1, variant="hbm")

# the non-slow interpret cases of tests/test_longread.py, by line
NWSWG_LONG_CASES = ["nw_multiblock", "swg_multiblock", "mixed_p1",
                    "mixed_p2", "score_only_nw", "score_only_swg",
                    "nrl1024_p2", "routing_p1", "routing_p2",
                    "swg_wide_retry", "swg_wide_retry_p2"]
# planes 4 and 8 (the slow ladder case of :626, and its npl=8 stage)
NWSWG_LONG_WIDE = ["ladder_p4", "ladder_p8", "swg_wide_retry_p4",
                   "swg_wide_retry_p8"]


def _near_diag(seed, n, lo, hi, R, nerr):
    import random
    rng = random.Random(seed)
    pairs = []
    for _ in range(n):
        lp = rng.randrange(lo, hi)
        pairs.append(make_pair(rng, lp, max(1, lp + rng.choice([-1, 0, 1])),
                               rng.randrange(0, nerr)))
    return pack(pairs, R)


def nwswg_long_case(name):
    """(cfg, pats, txts, plens, tlens, planes) of one named K6/K7 case."""
    import random
    if name == "nw_multiblock":          # :173, 2 row blocks
        return (AlignConfig(read_size=576, **NW_LONG),
                *_near_diag(77, 12, 430, 560, 576, 10), 1)
    if name == "swg_multiblock":         # :190, 3 row blocks
        return (AlignConfig(read_size=640, **SWG_LONG),
                *_near_diag(78, 12, 520, 620, 640, 10), 1)
    if name.startswith("mixed"):         # :208, empty to full length
        rng = random.Random(79)
        pairs = []
        for lp in (0, 1, 7, 100, 333, 560):
            lt = max(0, lp + (rng.choice([-1, 0, 1]) if lp > 2 else 0))
            pairs.append(make_pair(rng, lp, lt, max(0, lp // 64)))
        return (AlignConfig(read_size=576, **NW_LONG), *pack(pairs, 576),
                int(name[-1]))
    if name.startswith("score_only"):    # :667
        algo = name.split("_")[-1]
        kw = (dict(algo="nw", gap_i=2, gap_d=3, mismatch=3, max_score=60)
              if algo == "nw" else
              dict(algo="swg", match=0, mismatch=3, gap_o=4, gap_e=1,
                   max_score=400))
        cfg = AlignConfig(read_size=96, variant="hbm", backtrace=False, **kw)
        pairs = random_pairs(seed=7, n=128, max_len=90, balanced=False)
        return (cfg, *pack(pairs, 96), 1)
    if name == "nrl1024_p2":             # :783, runs past 256 lanes
        rng = np.random.default_rng(41)
        R, length = 640, 600
        bases = np.frombuffer(b"ACGT", np.uint8)
        pats = np.zeros((8, R), np.uint8)
        txts = np.zeros((8, R), np.uint8)
        for i, nsub in enumerate((140, 180, 200, 240, 140, 180, 200, 240)):
            p = bases[rng.integers(0, 4, length)]
            t = p.copy()
            idx = np.arange(0, 2 * nsub, 2)
            t[idx] = bases[(np.searchsorted(bases, t[idx]) + 1) % 4]
            pats[i, :length] = p
            txts[i, :length] = t
        cfg = AlignConfig(algo="nw", read_size=R, max_score=400,
                          backtrace=True, gap_i=1, gap_d=1, mismatch=1)
        return (cfg, pats, txts, np.full(8, length, np.int32),
                np.full(8, length, np.int32), 2)
    if name.startswith("routing"):       # :874
        rng = random.Random(17)
        pairs = [make_pair(rng, 40, 40, rng.randrange(0, 26))
                 for _ in range(8)]
        cfg = AlignConfig(algo="swg", read_size=48, max_score=260, match=0,
                          mismatch=3, gap_o=4, gap_e=1, backtrace=True,
                          variant="hbm")
        return (cfg, *pack(pairs, 48), int(name[-1]))
    if name.startswith("swg_wide_retry"):   # :304, flags at one plane
        return (AlignConfig(read_size=640, **SWG_LONG), *wide_retry_batch(),
                int(name[-1]) if name[-1].isdigit() else 1)
    if name.startswith("ladder"):        # :626, skew 141
        rng = random.Random(53)
        pairs = [make_pair(rng, 280, 280 + 141, 3),
                 make_pair(rng, 300, 300, 2)]
        cfg = AlignConfig(algo="nw", read_size=576, max_score=300,
                          backtrace=True, gap_i=2, gap_d=5, mismatch=1,
                          variant="hbm")
        return (cfg, *pack(pairs, 576), int(name[-1]))
    if name == "nw_p1_r200":
        # small cases for the CUDA source under the CPU shim
        cfg = AlignConfig(algo="nw", read_size=200, max_score=60,
                          backtrace=True, gap_i=2, gap_d=3, mismatch=3)
        return (cfg, *pack(random_pairs(seed=5, n=8, max_len=190,
                                        balanced=False), 200), 1)
    if name == "nw_ovf_p1":
        # costs of 150-200: cells pass int16 in the last rows, where the
        # range check runs (before row ~98 no valid cell can)
        cfg = AlignConfig(algo="nw", read_size=200, max_score=60,
                          backtrace=True, gap_i=200, gap_d=200,
                          mismatch=150)
        return (cfg, *pack(random_pairs(seed=15, n=8, max_len=196,
                                        balanced=False), 200), 1)
    if name == "swg_p2_r200":
        cfg = AlignConfig(read_size=200, **SWG_LONG)
        return (cfg, *pack(random_pairs(seed=6, n=8, max_len=190,
                                        balanced=False), 200), 2)
    raise KeyError(name)


def wide_retry_batch():
    """tests/test_longread.py:304: four pairs past the one-plane SWG
    envelope, one inside it, one aliasing pair (plen > tlen + 1)."""
    import random
    rng = random.Random(97)
    pairs = []
    for _ in range(4):
        lp = rng.randrange(560, 620)
        pairs.append(subs_pair(rng, lp, rng.randrange(51, 70)))
    pairs.append(make_pair(rng, 600, 600, 3))
    pairs.append(make_pair(rng, 200, 150, 0))
    return pack(pairs, 640)


GENASM_LONG_CASES = ["k40_r576", "k40_r576_nobt", "k160_r640"]


def genasm_long_case(name):
    """(cfg, pats, txts, plens, tlens) of one named GenASM long-tier case
    (tests/test_longread.py:224 and :354)."""
    import random
    if name.startswith("k40"):
        rng = random.Random(83)
        pairs = []
        for _ in range(8):
            lp = rng.randrange(430, 560)
            pairs.append(make_pair(rng, lp, max(1, lp + rng.choice(
                [-1, 0, 1])), rng.randrange(0, 12)))
        for _ in range(3):
            lp = rng.randrange(430, 560)
            pairs.append(make_pair(rng, lp, lp, rng.randrange(55, 80)))
        pairs.append(make_pair(rng, 500, 380, 0))
        pairs.append(make_pair(rng, 0, 37, 0))
        pairs.append(make_pair(rng, 0, 52, 0))
        cfg = AlignConfig(algo="genasm", read_size=576, max_score=40,
                          backtrace=not name.endswith("nobt"), mismatch=1,
                          gap_i=1, gap_d=1, variant="hbm")
        return (cfg, *pack(pairs, 576))
    if name == "k160_r640":
        rng = random.Random(101)
        pairs = [subs_pair(rng, 560, 40), subs_pair(rng, 600, 90),
                 burst_subs_pair(rng, 580, 150),
                 burst_subs_pair(rng, 610, 200), subs_pair(rng, 590, 150),
                 burst_subs_pair(rng, 540, 135)]
        cfg = AlignConfig(algo="genasm", read_size=640, max_score=160,
                          backtrace=True, mismatch=1, gap_i=1, gap_d=1,
                          variant="hbm")
        return (cfg, *pack(pairs, 640))
    raise KeyError(name)


# The dense exact tiers' cases: (algo, R, cfg kwargs, alphabet) -- the fuzz
# harness's cost models (tools/fuzz_kernels.py), its SWG rows 3-5 and 26
# among them (int8 cells the band cannot prove, a negative match cost), and
# overflow cases; the batches are unbalanced (aliasing and multi-aliasing
# pairs both occur).
DENSE_CASES = {
    "nw_r48_bt": ("nw", 48, dict(max_score=12, gap_i=2, gap_d=5, mismatch=1,
                                 backtrace=True), "ACGT"),
    "nw_r48_nobt": ("nw", 48, dict(max_score=16, gap_i=1, gap_d=1,
                                   mismatch=4), "ACGT"),
    "nw_r96_acgtn_bt": ("nw", 96, dict(max_score=24, gap_i=3, gap_d=2,
                                       mismatch=2, backtrace=True), "ACGTN"),
    # column 0's h * GAP_I passes int16 at h 33: most pairs flag
    "nw_int16_ovf_bt": ("nw", 112, dict(max_score=8, gap_i=1000,
                                        gap_d=1000, mismatch=1500,
                                        backtrace=True),
                        "ACGT"),
    "swg_row3_int8_bt": ("swg", 48, dict(max_score=30, match=0, mismatch=5,
                                         gap_o=6, gap_e=2, backtrace=True),
                         "ACGT"),
    "swg_row4_int8_bt": ("swg", 48, dict(max_score=60, match=0, mismatch=7,
                                         gap_o=2, gap_e=3, backtrace=True),
                         "ACGT"),
    "swg_row5_match-1_bt": ("swg", 96, dict(max_score=200, match=-1,
                                            mismatch=2, gap_o=3, gap_e=1,
                                            variant="hbm", backtrace=True),
                            "ACGT"),
    "swg_row5_match-1_nobt": ("swg", 96, dict(max_score=200, match=-1,
                                              mismatch=2, gap_o=3, gap_e=1,
                                              variant="hbm"), "ACGT"),
    "swg_row26_acgtn_bt": ("swg", 48, dict(max_score=30, match=0, mismatch=5,
                                           gap_o=6, gap_e=2, backtrace=True),
                           "ACGTN"),
    "wfa_r48_bt": ("wfa", 48, dict(max_score=20, mismatch=2, gap_o=3,
                                   gap_e=2, backtrace=True), "ACGT"),
    "wfa_r96_adaptive_bt": ("wfa", 96, dict(max_score=40, mismatch=3,
                                            gap_o=4, gap_e=1, adaptive=True,
                                            backtrace=True), "ACGT"),
    "wfa_r96_adaptive_nobt": ("wfa", 96, dict(max_score=40, mismatch=3,
                                              gap_o=4, gap_e=1,
                                              adaptive=True), "ACGT"),
    # most pairs past smax 4: the overflow score, no history walked
    "wfa_r48_overflow_bt": ("wfa", 48, dict(max_score=4, mismatch=3, gap_o=4,
                                            gap_e=1, adaptive=True,
                                            backtrace=True), "ACGT"),
    "wfa_r48_acgtn_bt": ("wfa", 48, dict(max_score=14, mismatch=5, gap_o=2,
                                         gap_e=1, backtrace=True), "ACGTN"),
}


def dense_batch(R, alphabet, n=64, seed=17):
    return pack(random_pairs(seed=seed, n=n, max_len=R - 8, balanced=False,
                             alphabet=alphabet), R)
