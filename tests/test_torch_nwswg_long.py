"""K6/K7 (the streamed NW/SWG tier, aim_tpu_torch/ops/nwswg_long.py)
against the JAX package's ``_nwswg_long_jit`` in interpret mode.

The plain PyTorch versions the port runs on CPU tensors must give records
byte-equal to the Pallas kernels (flag bits and the split lane-0 cursor
included) on the non-slow cases of tests/test_longread.py; the geometry,
admission and routing copies must equal the reference's over a config
grid.  Planes 4 and 8 are held against JAX in the slow suite and against
the oracle here.  Tolerance: exact bytes.
"""

import itertools

import numpy as np
import pytest
import torch

import aim_tpu.native as nat
from aim_tpu.config import AlignConfig, derive_config
from aim_tpu.ops import nwswg_pallas_long as jlong
from aim_tpu_torch.ops import common, kernels, nwswg_long
from torch_cases import (NWSWG_LONG_CASES, NWSWG_LONG_WIDE, garbage_padded,
                         nwswg_long_case)

T = torch.from_numpy


def _jax(cfg, p, t, pl, tl, planes, packed=False):
    if packed:
        p, t = common.pack_seqs(p, t, pl, tl, cfg.read_size)[:2]
    return np.asarray(jlong._nwswg_long_jit(
        p, t, pl.astype(np.int32), tl.astype(np.int32), cfg=cfg,
        interpret=True, packed=packed, npl=planes)["packed_runs"])


def _port(cfg, p, t, pl, tl, planes, packed=False):
    if packed:
        p, t = common.pack_seqs(p, t, pl, tl, cfg.read_size)[:2]
    return nwswg_long.nwswg_forward_long(
        T(np.ascontiguousarray(p)), T(np.ascontiguousarray(t)),
        T(np.ascontiguousarray(pl, np.int32)),
        T(np.ascontiguousarray(tl, np.int32)), cfg=cfg, packed=packed,
        planes=planes).numpy()


@pytest.fixture(scope="module")
def jax_records():
    """JAX interpret records of each case, computed once a module."""
    cache = {}

    def get(name):
        if name not in cache:
            cfg, p, t, pl, tl, planes = nwswg_long_case(name)
            cache[name] = _jax(cfg, p, t, pl, tl, planes)
        return cache[name]
    return get


def _flags(rec):
    lane0 = rec[:, 0].astype(np.int32)
    return (lane0 >> 8) & 1, (lane0 >> 9) & 1


@pytest.mark.parametrize("name", NWSWG_LONG_CASES)
def test_plain_matches_pallas_interpret(jax_records, name):
    cfg, p, t, pl, tl, planes = nwswg_long_case(name)
    want = jax_records(name)
    got = _port(cfg, p, t, pl, tl, planes)
    assert got.dtype == np.int16 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_int16_range_check_matches_pallas_interpret(jax_records):
    """NW at costs of 150-200: valid cells pass int16 in the last rows, and
    the forward flags match the reference's."""
    cfg, p, t, pl, tl, planes = nwswg_long_case("nw_ovf_p1")
    want = jax_records("nw_ovf_p1")
    np.testing.assert_array_equal(_port(cfg, p, t, pl, tl, planes), want)
    assert _flags(want)[1].any()


def test_cases_reach_what_they_cover(jax_records):
    """The cases hit the paths they stand for: several row blocks, flagged
    pairs, records past 256 lanes with the cursor's high bits set, and
    score-only runs whose flags carry both bits."""
    assert {nwswg_long_case(n)[0].read_size for n in NWSWG_LONG_CASES} \
        >= {576, 640}
    big = jax_records("nrl1024_p2")
    assert big.shape[1] == 1024
    assert ((big[:, 0].astype(np.int32) >> 10) > 0).any()
    fb, fs = _flags(jax_records("swg_wide_retry"))
    assert fb[:4].all() and not fb[4] and fb[5]
    so, so9 = _flags(jax_records("score_only_nw"))
    assert so.any() and (so == so9).all()


@pytest.mark.parametrize("name", ["nw_multiblock", "swg_multiblock",
                                  "mixed_p2", "score_only_swg"])
def test_packed_equals_raw(name):
    cfg, p, t, pl, tl, planes = nwswg_long_case(name)
    np.testing.assert_array_equal(_port(cfg, p, t, pl, tl, planes, True),
                                  _port(cfg, p, t, pl, tl, planes))


@pytest.mark.parametrize("packed", [False, True], ids=["raw", "packed"])
@pytest.mark.parametrize("name", ["nw_multiblock", "swg_multiblock"])
def test_garbage_past_lengths_leaves_records(jax_records, name, packed):
    cfg, p, t, pl, tl, planes = nwswg_long_case(name)
    gp, gt = garbage_padded(p, t, pl, tl)
    np.testing.assert_array_equal(_port(cfg, gp, gt, pl, tl, planes, packed),
                                  jax_records(name))


def _oracle(cfg, p, t, pl, tl):
    if cfg.algo == "nw":
        return nat.nw_align(p, t, pl, tl, mismatch=cfg.mismatch,
                            gap_i=cfg.gap_i, gap_d=cfg.gap_d, backtrace=True)
    return nat.swg_align(p, t, pl, tl, match=cfg.match,
                         mismatch=cfg.mismatch, gap_o=cfg.gap_o,
                         gap_e=cfg.gap_e, max_score=cfg.max_score,
                         cell_width=2, backtrace=True)


@pytest.mark.parametrize("name", NWSWG_LONG_WIDE + ["nw_multiblock",
                                                    "swg_wide_retry_p2"])
def test_plain_records_decode_to_oracle(name):
    """Every pair the plain version certifies (planes 4 and 8 included)
    decodes to the oracle's score and CIGAR."""
    cfg, p, t, pl, tl, planes = nwswg_long_case(name)
    rec = _port(cfg, p, t, pl, tl, planes)
    ok = _flags(rec)[0] == 0
    assert ok.any()
    sc = rec[:, 1].astype(np.int32)
    osc, oops, ob, oe = _oracle(cfg, p, t, pl, tl)
    np.testing.assert_array_equal(sc[ok], osc[ok])
    ops, b, e = nat.wfa_runs_to_ops(rec, sc, pl, tl, max_score=1 << 30,
                                    max_ops=2 * cfg.read_size + 8)
    for i in np.nonzero(ok)[0]:
        assert ops[i, b[i]:e[i]].tobytes() == oops[i, ob[i]:oe[i]].tobytes()


@pytest.mark.slow
@pytest.mark.parametrize("name", NWSWG_LONG_WIDE)
def test_wide_planes_match_pallas_interpret(name):
    cfg, p, t, pl, tl, planes = nwswg_long_case(name)
    np.testing.assert_array_equal(_port(cfg, p, t, pl, tl, planes),
                                  _jax(cfg, p, t, pl, tl, planes))


def _config_grid():
    for R in (2, 96, 576, 1528, 4144, 10112, 16352, 16360):
        for smax in (0, 5, 82, 205, 328, 700, 2000):
            yield AlignConfig(algo="nw", read_size=R, max_score=smax)
            yield AlignConfig(algo="nw", read_size=R, max_score=smax,
                              gap_i=1, gap_d=1, mismatch=1)
            yield AlignConfig(algo="nw", read_size=R, max_score=smax,
                              gap_i=0, gap_d=2, mismatch=3)
            for m, x, o, e, var in ((0, 3, 4, 1, "hbm"), (0, 7, 2, 3, "hbm"),
                                    (-1, 2, 3, 1, "hbm"), (0, 4, 6, 2, "vmem"),
                                    (0, 3, 4, 0, "hbm")):
                yield AlignConfig(algo="swg", read_size=R, max_score=smax,
                                  match=m, mismatch=x, gap_o=o, gap_e=e,
                                  variant=var)
    for algo, length, err in itertools.product(
            ("nw", "swg"), (1000, 2000, 4096, 8000, 10000, 12000, 16000),
            (0.005, 0.01, 0.02)):
        yield derive_config(algo, length, err, backtrace=True, variant="hbm")


def test_geometry_copies_match_reference(monkeypatch):
    n = 0
    for cfg in _config_grid():
        n += 1
        assert nwswg_long.long_fit_nwswg(cfg) == jlong.long_fit_nwswg(cfg)
        assert nwswg_long.runs_lanes_long(cfg) == jlong.runs_lanes_long(cfg)
        for npl in (1, 2, 4, 8):
            assert nwswg_long.band_c(npl) == jlong.band_c(npl)
            assert nwswg_long.block_rows(cfg.algo, npl) == \
                jlong.block_rows(cfg.algo, npl)
        if min(cfg.gap_i, cfg.gap_d, cfg.gap_e) > 0:
            for route in ("1", "0"):
                monkeypatch.setenv("AIM_TPU_ROUTE", route)
                for mp in (1, 2, 4, 8):
                    assert nwswg_long.route_planes(cfg, mp) == \
                        jlong.route_planes(cfg, mp), (cfg, route, mp)
            monkeypatch.delenv("AIM_TPU_ROUTE")
    assert n > 300
    # the issue's sizes: NW at one plane, SWG at two
    nw4 = derive_config("nw", 4096, 0.01, backtrace=True, variant="hbm")
    swg4 = derive_config("swg", 4096, 0.01, backtrace=True, variant="hbm")
    assert (nw4.read_size, nw4.max_score) == (4144, 328)
    assert nwswg_long.route_planes(nw4) == 1
    assert nwswg_long.route_planes(swg4) == 2


def test_lane0_packing_matches_reference():
    import jax.numpy as jnp
    rc = np.array([-5, 0, 1, 254, 255, 256, 511, 700, 1023, 2000], np.int32)
    for NRL in (256, 512, 1024):
        for flag, meta in ((0, 0), (1, 0), (1, 1)):
            f = np.full_like(rc, flag)
            m = np.full_like(rc, meta)
            want = np.asarray(jlong._pack_lane0(jnp.asarray(rc),
                                                jnp.asarray(f),
                                                jnp.asarray(m), NRL))
            got = nwswg_long.pack_lane0(T(rc), T(f), T(m), NRL).numpy()
            np.testing.assert_array_equal(got, want)


def test_device_bytes_is_the_ports_layout():
    cfg = derive_config("nw", 4096, 0.01, backtrace=True, variant="hbm")
    R = cfg.read_size
    per1 = nwswg_long.device_bytes_per_pair(cfg, 1)
    assert per1 == 2 * R + 16 + 2 * 256 + R * (32 + 16)
    assert nwswg_long.device_bytes_per_pair(cfg, 2) - per1 == R * 48
    so = cfg.replace(backtrace=False)
    assert nwswg_long.device_bytes_per_pair(so, 8) == 2 * R + 16 + 2 * 256
    swg = derive_config("swg", 4096, 0.01, backtrace=True, variant="hbm")
    assert nwswg_long.row_bytes(swg, 2) == (128, 32)


def test_cpu_wrapper_runs_plain_version_without_launch():
    nwswg_long.reset_launch_count()
    cfg, p, t, pl, tl, planes = nwswg_long_case("routing_p2")
    _port(cfg, p, t, pl, tl, planes)
    assert nwswg_long.launch_count == nwswg_long.walk_launch_count == 0


@pytest.mark.parametrize("bad", ["pats_dtype", "lens_dtype", "rows",
                                 "planes", "gate", "int8"])
def test_wrapper_rejects_bad_inputs(bad):
    cfg, p, t, pl, tl, planes = nwswg_long_case("routing_p1")
    p, t, pl, tl = (T(np.ascontiguousarray(a)) for a in (p, t, pl, tl))
    pl, tl = pl.to(torch.int32), tl.to(torch.int32)
    if bad == "pats_dtype":
        p = p.to(torch.int32)
    elif bad == "lens_dtype":
        pl = pl.to(torch.int64)
    elif bad == "rows":
        tl = tl[:4]
    elif bad == "planes":
        planes = 3
    elif bad == "gate":
        cfg = cfg.replace(read_size=16360)
    elif bad == "int8":
        cfg = cfg.replace(variant="vmem", max_score=100)
    with pytest.raises((TypeError, ValueError)):
        nwswg_long.nwswg_forward_long(p, t, pl, tl, cfg=cfg, planes=planes)


def test_streamed_tier_serves_past_the_short_tiers():
    """NW past K2's gate and SWG int16 configs past K3's reach K6/K7 at
    the routed plane count, with the ladder above it."""
    for algo, planes in (("nw", 1), ("swg", 2)):
        cfg = derive_config(algo, 4096, 0.01, backtrace=True, variant="hbm")
        tier = kernels.forward_fn(cfg)
        assert tier.forward.func is nwswg_long.nwswg_forward_long
        assert tier.forward.keywords == {"planes": planes}
        assert tier.primary_planes == planes
        assert tier.retry is nwswg_long.nwswg_forward_long
        assert tier.device_bytes_per_pair == \
            nwswg_long.device_bytes_per_pair(cfg, planes)
