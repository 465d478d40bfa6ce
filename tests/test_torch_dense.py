"""The dense exact tiers of the port (aim_tpu_torch/ops/{nw,swg,wfa}_xla.py)
against the JAX package's XLA tier (aim_tpu/ops/{nw,swg,wfa}_xla.py).

The same numpy-seeded pairs (tests/util.py, unbalanced lengths: tape
aliasing plen == tlen + 1 and plen > tlen + 1 both occur) go through both;
scores, needs_fallback, direction bits, packed_hist and packed_meta must be
byte-equal.  Then ``aim_tpu_torch.api.align`` on the CPU under
``backend="xla"``, and on the configs no kernel admits, must equal
``aim_tpu.api.align`` and the native oracle.  Tolerance: exact.
"""

import os

import numpy as np
import pytest
import torch

import aim_tpu.native as nat
from aim_tpu import api as japi
from aim_tpu.config import AlignConfig, derive_config
from aim_tpu.ops import common as jcommon
from aim_tpu.ops import nw_xla as jnw
from aim_tpu.ops import pallas_kernels
from aim_tpu.ops import swg_xla as jswg
from aim_tpu.ops import wfa_xla as jwfa
from aim_tpu_torch import api as tapi
from aim_tpu_torch.ops import common, kernels, nw_xla, swg_xla, wfa_xla
from torch_cases import DENSE_CASES, dense_batch

SAMPLE_PAIRS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "sample-l100-e1-2K")

FORWARDS = {"nw": (jnw.nw_forward, nw_xla.nw_forward),
            "swg": (jswg.swg_forward, swg_xla.swg_forward),
            "wfa": (jwfa.wfa_forward, wfa_xla.wfa_forward)}


def _batch(R, alphabet, n=64):
    return dense_batch(R, alphabet, n)


@pytest.mark.parametrize("name", list(DENSE_CASES))
def test_dense_tier_matches_jax_xla(name):
    algo, R, kw, alphabet = DENSE_CASES[name]
    cfg = AlignConfig(algo=algo, read_size=R, **kw)
    p, t, pl, tl = _batch(R, alphabet)
    assert (pl == tl + 1).any() and (pl > tl + 1).any()
    jfwd, tfwd = FORWARDS[algo]
    want = {k: np.asarray(v) for k, v in jfwd(p, t, pl, tl, cfg=cfg).items()}
    nw_xla.reset_call_count()
    swg_xla.reset_call_count()
    wfa_xla.reset_call_count()
    got = tfwd(*(torch.from_numpy(a) for a in (p, t, pl, tl)), cfg=cfg)
    assert sum(m.call_count for m in (nw_xla, swg_xla, wfa_xla)) == 1
    assert set(got) == set(want)
    for k in want:
        assert got[k].numpy().dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    if "needs_fallback" in want:
        assert want["needs_fallback"].any()   # aliasing at least
    if "ovf" in name:
        assert want["needs_fallback"].mean() > 0.5
    if "overflow" in name:
        assert (want["scores"] > cfg.max_score).mean() > 0.5


def test_lane_helpers_match_reference():
    """min_plus_scan (cummin, capped at 2**24 as the reference's masked
    log-step scan caps it), shift_right_lanes and gather_lane, on values
    past 2**24 too."""
    rng = np.random.default_rng(4)
    for w in (1, 2, 7, 113):
        z = rng.integers(-2 ** 25, 2 ** 25, size=(6, w)).astype(np.int32)
        for slope in (1, 5):
            np.testing.assert_array_equal(
                common.min_plus_scan(torch.from_numpy(z), slope).numpy(),
                np.asarray(jcommon.min_plus_scan(z, slope, w)))
        np.testing.assert_array_equal(
            common.shift_right_lanes(torch.from_numpy(z), -3).numpy(),
            np.asarray(jcommon.shift_right_lanes(z, -3)))
        idx = rng.integers(-2, w + 2, size=6).astype(np.int32)
        np.testing.assert_array_equal(
            common.gather_lane(torch.from_numpy(z),
                               torch.from_numpy(idx)).numpy(),
            np.asarray(jcommon.gather_lane(z, idx)))


def test_dense_tiers_take_raw_bytes():
    cfg = derive_config("nw", 100, 0.01)
    p, t, pl, tl = (torch.from_numpy(a) for a in _batch(112, "ACGT", 4))
    for fwd in (nw_xla.nw_forward, swg_xla.swg_forward, wfa_xla.wfa_forward):
        with pytest.raises(ValueError):
            fwd(p, t, pl, tl, cfg=cfg, packed=True)


def test_nm_table_in_slices_equals_whole(monkeypatch):
    """The NM build's diagonal slices (a bounded cummin scratch) change
    nothing: seven diagonals a slice equal the reference's whole build."""
    p, t, pl, tl = _batch(96, "ACGT", 16)
    want = np.asarray(jwfa.build_nm_table(p, t, pl, tl, 40, 96))
    monkeypatch.setattr(wfa_xla, "NM_SLICE_ELEMS", 7 * 97)
    got = wfa_xla.build_nm_table(*(torch.from_numpy(a) for a in (p, t, pl,
                                                                 tl)), 40, 96)
    np.testing.assert_array_equal(got.numpy(), want)


def _oracle(cfg, p, t, pl, tl):
    if cfg.algo == "wfa":
        return nat.wfa_align(p, t, pl, tl, mismatch=cfg.mismatch,
                             gap_o=cfg.gap_o, gap_e=cfg.gap_e,
                             max_score=cfg.max_score, adaptive=cfg.adaptive,
                             backtrace=cfg.backtrace)
    return tapi._oracle_align(p, t, pl, tl, cfg)


def _same(res, want, cfg):
    np.testing.assert_array_equal(res.scores, want.scores)
    if cfg.backtrace:
        for i in range(len(res.scores)):
            assert res.ops[i, res.begin[i]:res.end[i]].tobytes() == \
                want.ops[i, want.begin[i]:want.end[i]].tobytes(), i


@pytest.mark.parametrize("cfg,n", [
    (derive_config("wfa", 100, 0.01, backtrace=True, adaptive=True), 300),
    (derive_config("wfa", 100, 0.01, backtrace=True), 300),
    (derive_config("nw", 100, 0.01, backtrace=True), 300),
    (derive_config("swg", 100, 0.01, backtrace=True), 300),
    (derive_config("swg", 100, 0.01), 300),
    (derive_config("genasm", 100, 0.01, backtrace=True), 300),
], ids=["wfa-b-r", "wfa-b", "nw-b", "swg-b", "swg", "genasm-b"])
def test_align_backend_xla_matches_jax_and_oracle(cfg, n):
    """``api.align`` under backend="xla": the dense tiers (the host tier
    for GenASM) on the sample pairs, equal to JAX's XLA / host tier and to
    the oracle; no kernel runs."""
    cfg = cfg.replace(backend="xla")
    p, t, pl, tl = nat.parse_pairs(SAMPLE_PAIRS, n, cfg.read_size)
    tier = kernels.forward_fn(cfg)
    assert tier.name == ("host" if cfg.algo == "genasm" else "dense")
    res = tapi.align(p, t, pl, tl, cfg, device="cpu")
    want = japi.align(p, t, pl, tl, cfg)
    _same(res, want, cfg)
    osc, oops, ob, oe = _oracle(cfg, p, t, pl, tl)
    np.testing.assert_array_equal(res.scores, osc)
    assert res.n_fallback == want.n_fallback


@pytest.mark.parametrize("cfg,n,gen", [
    # a negative match cost voids K3's band argument
    (derive_config("swg", 100, 0.01, match=-1, backtrace=True), 64, None),
    # past K5's smax 1023 at a small read size
    (AlignConfig(algo="wfa", read_size=112, max_score=1024, backtrace=True,
                 adaptive=True), 16, None),
    # int8 cells the band cannot prove (fuzz row 3's costs) on aliasing and
    # overflowing pairs
    (AlignConfig(algo="swg", read_size=48, max_score=30, match=0,
                 mismatch=5, gap_o=6, gap_e=2, backtrace=True), 128, "ACGT"),
    # past the GenASM long tier's k 508: the host tier
    (AlignConfig(algo="genasm", read_size=112, max_score=509,
                 backtrace=True), 64, None),
], ids=["swg-m-1", "wfa-smax1024", "swg-int8-unsound", "genasm-k509"])
def test_formerly_refused_configs(cfg, n, gen):
    """Configs no kernel admits run on the exact tier, where JAX's Pallas
    dispatch returns none, and equal JAX's align and the oracle."""
    assert pallas_kernels.forward_fn(cfg) is None
    tier = kernels.forward_fn(cfg)
    assert tier.name == ("host" if cfg.algo == "genasm" else "dense")
    assert tier.retry is None
    if gen is None:
        p, t, pl, tl = nat.parse_pairs(SAMPLE_PAIRS, n, cfg.read_size)
    else:
        p, t, pl, tl = _batch(cfg.read_size, gen, n)
    res = tapi.align(p, t, pl, tl, cfg, device="cpu")
    _same(res, japi.align(p, t, pl, tl, cfg.replace(backend="xla")), cfg)
    osc, oops, ob, oe = _oracle(cfg, p, t, pl, tl)
    np.testing.assert_array_equal(res.scores, osc)
    for i in range(n):
        assert res.ops[i, res.begin[i]:res.end[i]].tobytes() == \
            oops[i, ob[i]:oe[i]].tobytes(), i
    if gen is not None:
        assert res.n_fallback > 0   # flagged dense pairs went to the oracle


def test_dense_footprint_counts_its_tensors():
    """The chunk cap takes the dense tier's own bytes a pair: the NM table
    and its build slice, the history, the direction codes."""
    w = AlignConfig(algo="wfa", read_size=4152, max_score=1024,
                    backtrace=True)
    K = 2 * 1024 + 1
    per = kernels.forward_fn(w).device_bytes_per_pair
    assert per == wfa_xla.device_bytes_per_pair(w)
    assert per > K * 4153 * 2 + 1026 * 3 * K * 2
    assert per < 3 * (K * 4153 * 2 + 1026 * 3 * K * 2)
    n = derive_config("nw", 20000, 0.01, backtrace=True, variant="hbm")
    assert kernels.forward_fn(n).device_bytes_per_pair > \
        (n.read_size + 1) * nw_xla.bits_width(n.read_size)
