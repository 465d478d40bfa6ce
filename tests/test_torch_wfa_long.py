"""K5 of the PyTorch port (aim_tpu_torch/ops/wfa_long.py) against the JAX
reference kernel.

The same numpy inputs go through the reference Pallas kernel
``aim_tpu.ops.wfa_pallas_long.wfa_forward_pallas_long`` (and its byte-word
variant) in interpret mode and through the port's plain PyTorch version;
the step records must be byte-equal (tolerance: exact -- they are
integers).  The CUDA kernel is held to the same plain version on the card
(tests/test_torch_gpu.py and ``chip_smoke.py``).
"""

import random

import numpy as np
import pytest
import torch

import aim_tpu.native as nat
from aim_tpu.config import AlignConfig, derive_config
from aim_tpu.ops import wfa_pallas_long as jref
from aim_tpu_torch.ops import common, wfa2, wfa_long
from torch_cases import (WFA_LONG_CASES, garbage_padded, torch_records,
                         wfa_long_case)
from util import make_pair, pack, random_pairs

BASE_10K = derive_config("wfa", 10000, 0.01, backtrace=True, adaptive=True,
                         variant="hbm")


def _jax_records(cfg, p, t, pl, tl):
    pp, pt, packed = common.pack_seqs(p, t, pl, tl, cfg.read_size)
    if packed:
        out = jref.wfa_forward_pallas_long(pp, pt, pl, tl, cfg=cfg,
                                           interpret=True, packed=True)
    else:
        out = jref.wfa_forward_pallas_long_bytes(p, t, pl, tl, cfg=cfg,
                                                 interpret=True)
    return np.asarray(out["step_records"])


def _torch_records(cfg, p, t, pl, tl, fn=wfa_long.wfa_long_reference,
                   pack_ok=True):
    """fn on the batch as the api hands it over: 2-bit packed when the
    alphabet allows (and pack_ok), else raw bytes."""
    pp, pt, packed = common.pack_seqs(p, t, pl, tl, cfg.read_size)
    if not (packed and pack_ok):
        pp, pt, packed = p, t, False
    return torch_records(fn, cfg, pp, pt, pl, tl, packed)


@pytest.mark.parametrize("name", WFA_LONG_CASES)
def test_reference_matches_pallas_interpret(name):
    cfg, p, t, pl, tl = wfa_long_case(name)
    want = _jax_records(cfg, p, t, pl, tl)
    got = _torch_records(cfg, p, t, pl, tl)
    assert got.shape == (len(pl), cfg.max_score + 4)
    np.testing.assert_array_equal(got, want)


def test_word_layouts_give_equal_records():
    """2-bit packed and raw-byte inputs give the same records (the
    reference's layouts agree too: tests/test_longread.py)."""
    cfg, p, t, pl, tl = wfa_long_case("r264_s40_ad")
    np.testing.assert_array_equal(
        _torch_records(cfg, p, t, pl, tl, pack_ok=False),
        _torch_records(cfg, p, t, pl, tl))


@pytest.mark.parametrize("adaptive", [True, False])
def test_long_reference_equals_short_reference(adaptive):
    """K5 computes K1's function: on a config both tiers admit, with
    overflow pairs (score 41) present, the records are equal."""
    rng = random.Random(5)
    pairs = []
    for _ in range(16):
        plen = rng.randrange(150, 240)
        tlen = plen + rng.choice([-1, 0, 1])
        pairs.append(make_pair(rng, plen, tlen, rng.randrange(0, 16)))
    p, t, pl, tl = pack(pairs, 248)
    cfg = AlignConfig(algo="wfa", read_size=248, max_score=40,
                      backtrace=True, adaptive=adaptive)
    assert wfa2.vmem_fit2(cfg) and wfa_long.long_fit(cfg)
    short = torch_records(wfa2.wfa2_reference, cfg, p, t, pl, tl, False)
    assert (short[:, 43] == 41).any() and (short[:, 43] <= 40).any()
    np.testing.assert_array_equal(_torch_records(cfg, p, t, pl, tl), short)


@pytest.mark.parametrize("adaptive", [True, False])
def test_plain_versions_count_the_same_work(adaptive):
    """The plain versions' ``stats`` (the live band the WFA bound and
    tools/row_profile.py count): K1's next-mismatch table and K5's
    windowed extend find the same levels, live cells and matched bases on
    one batch, within K and the levels reached; gathering them changes no
    record."""
    cfg = AlignConfig(algo="wfa", read_size=248, max_score=40,
                      backtrace=True, adaptive=adaptive)
    p, t, pl, tl = pack(random_pairs(seed=13, n=24, max_len=240), 248)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        p, t, np.asarray(pl, np.int32), np.asarray(tl, np.int32))]
    short, long_ = {}, {}
    rec = wfa2.wfa2_reference(*args, cfg=cfg, stats=short).numpy()
    np.testing.assert_array_equal(
        wfa_long.wfa_long_reference(*args, cfg=cfg, stats=long_).numpy(),
        rec)
    np.testing.assert_array_equal(
        wfa2.wfa2_reference(*args, cfg=cfg).numpy(), rec)
    assert short == long_
    reached = int((np.minimum(rec[:, 43], 40) + 1).sum())
    assert 0 < short["levels"] <= reached
    assert short["levels"] <= short["live_cells"] <= 81 * short["levels"]
    assert 0 < short["max_width"] <= 81 and short["ext_bases"] > 0


def test_records_decode_to_oracle_10kbp():
    """Scores and CIGARs at the 10 kbp config (READ_SIZE 10112, MAX_SCORE
    500) equal the exact native oracle; bytes past the lengths change
    nothing."""
    cfg = BASE_10K
    assert (cfg.read_size, cfg.max_score) == (10112, 500)
    from aim_tpu import datagen
    p, t, pl, tl = datagen.generate_pairs(3, 10000, 0.01,
                                          read_size=cfg.read_size, seed=4)
    rec = _torch_records(cfg, p, t, pl, tl)
    sc, ops, b, e = nat.wfa_steps_to_ops(rec, pl, tl, max_score=500,
                                         max_ops=2 * cfg.read_size)
    osc, oops, ob, oe = nat.wfa_align(p, t, pl, tl, mismatch=3, gap_o=4,
                                      gap_e=1, max_score=500, adaptive=True,
                                      backtrace=True)
    np.testing.assert_array_equal(sc, osc)
    assert (osc <= 500).all()
    for i in range(len(pl)):
        assert ops[i, b[i]:e[i]].tobytes() == oops[i, ob[i]:oe[i]].tobytes()
    gp, gt = garbage_padded(p, t, pl, tl)
    np.testing.assert_array_equal(_torch_records(cfg, gp, gt, pl, tl), rec)


def test_admission_matches_reference():
    for smax in (0, 5, 40, 200, 500, 800, 1000, 1023, 1024, 1500):
        for R in (8, 112, 264, 1024, 4096, 10112, 16168, 16376, 16384):
            cfg = AlignConfig(algo="wfa", read_size=R, max_score=smax)
            for bytes_mode in (False, True):
                assert wfa_long.long_tile_pairs(cfg, bytes_mode) == \
                    jref.long_tile_pairs(cfg, bytes_mode), (R, smax)
                assert wfa_long.long_fit(cfg, bytes_mode) == \
                    jref.long_fit(cfg, bytes_mode)
            assert wfa_long.ring_depths(cfg) == jref.ring_depths(cfg)
        assert wfa_long.record_cols(smax) == jref.record_cols(smax)
    # the 16 kbp edge runs a smaller tile; the smax cap is exactly 1023
    edge = derive_config("wfa", 16000, 0.01, backtrace=True, adaptive=True,
                         variant="hbm")
    assert edge.max_score == 800 and wfa_long.long_tile_pairs(edge) <= 48
    assert wfa_long.long_tile_pairs(BASE_10K) == 64
    for bytes_mode in (False, True):
        assert wfa_long.long_fit(BASE_10K.replace(max_score=1023),
                                 bytes_mode)
        assert not wfa_long.long_fit(BASE_10K.replace(max_score=1024),
                                     bytes_mode)


def test_device_bytes_per_pair():
    """The history, 3.0 MB a pair at smax 500, dominates; half of an
    80 GB card's memory holds about 13k pairs of it."""
    per = wfa_long.device_bytes_per_pair(BASE_10K)
    assert wfa_long.hist_bytes_per_pair(BASE_10K) == 3 * 501 * 1001 * 2
    assert 3_000_000 < per < 3_040_000
    assert 12_000 < (40 << 30) // per < 14_500
    # shared memory a warp in csrc/wfa_long.cu: klo/khi/flags and the two
    # staged sequences
    assert wfa_long.warp_smem_bytes(BASE_10K, True) < 12 * 1024
    assert wfa_long.warp_smem_bytes(BASE_10K, False) < 27 * 1024
    top = AlignConfig(algo="wfa", read_size=16376, max_score=1023)
    assert wfa_long.WARPS * wfa_long.warp_smem_bytes(top, False) \
        <= 227 * 1024


def test_cpu_wrapper_runs_plain_version_without_launch():
    wfa_long.reset_launch_count()
    cfg, p, t, pl, tl = wfa_long_case("r264_s40_ad")
    np.testing.assert_array_equal(
        _torch_records(cfg, p, t, pl, tl, fn=wfa_long.wfa_forward_long),
        _torch_records(cfg, p, t, pl, tl))
    assert wfa_long.launch_count == 0


@pytest.mark.parametrize("bad", ["gate", "pats_dtype", "widths"])
def test_wrapper_rejects_bad_inputs(bad):
    cfg, p, t, pl, tl = wfa_long_case("r264_s40_ad")
    p, t, pl, tl = (torch.from_numpy(np.ascontiguousarray(a))
                    for a in (p, t, pl, tl))
    if bad == "gate":
        cfg = cfg.replace(max_score=1024)
    elif bad == "pats_dtype":
        p = p.to(torch.int32)
    elif bad == "widths":
        t = t[:, :100].contiguous()
    with pytest.raises((TypeError, ValueError)):
        wfa_long.wfa_forward_long(p, t, pl, tl, cfg=cfg, packed=False)
