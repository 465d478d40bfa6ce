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
