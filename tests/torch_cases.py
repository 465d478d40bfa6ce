"""Seeded K1, K2 and K3 input cases shared by the port's CPU tests
(against the JAX kernels) and its GPU tests (against the plain PyTorch
versions).  Imports no jax, so the GPU tests run on hosts without it.
Imported by its top-level name: pytest puts tests/ first on sys.path, and
a ``tests`` package installed elsewhere cannot shadow it then."""

import numpy as np
import torch

from aim_tpu import datagen
from aim_tpu.config import AlignConfig, derive_config
from aim_tpu_torch.ops import common
from util import pack, random_pairs

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
               "nw_l128"]

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
    raise KeyError(name)


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
                "overflow_nobt", "r64_k26_bt"]

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
