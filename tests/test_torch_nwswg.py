"""K2 (NW) and K3 (SWG) of the PyTorch port (aim_tpu_torch/ops/nw.py,
ops/swg.py) against the JAX reference kernels.

The same numpy inputs go through the reference Pallas kernels
``aim_tpu.ops.nw_pallas.nw_forward_pallas`` / ``swg_pallas.
swg_forward_pallas`` in interpret mode and through the port's plain
PyTorch versions; the packed-run records must be byte-equal, flagged pairs
included (tolerance: exact -- they are integers).  The CUDA kernels are
held to the same plain versions on the card (tests/test_torch_gpu.py and
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import aim_tpu.native as nat
from aim_tpu.config import AlignConfig, derive_config
from aim_tpu.ops import nw_pallas as jnw
from aim_tpu.ops import nwswg_pallas_long as jlong
from aim_tpu.ops import pallas_kernels as jdispatch
from aim_tpu.ops import swg_pallas as jswg
from aim_tpu_torch import api as tapi
from aim_tpu_torch.ops import common, kernels, nw, swg
from torch_cases import (NW_MAIN, NWSWG_CASES, SWG_MAIN, datagen_batch,
                         garbage_padded, nwswg_case, nwswg_records)

MAINS = {"nw": NW_MAIN, "swg": SWG_MAIN}


def _jax_records(cfg, p, t, pl, tl, packed):
    fn = jnw.nw_forward_pallas if cfg.algo == "nw" \
        else jswg.swg_forward_pallas
    out = fn(p, t, np.asarray(pl, np.int32), np.asarray(tl, np.int32),
             cfg=cfg, interpret=True, packed=packed)
    return np.asarray(out["packed_runs"])


def _flags(rec):
    return ((rec[:, 0].astype(np.int32) >> 8) & 1).astype(bool)


@pytest.mark.parametrize("name", NWSWG_CASES)
def test_reference_matches_pallas_interpret(name):
    cfg, p, t, pl, tl, packed = nwswg_case(name)
    want = _jax_records(cfg, p, t, pl, tl, packed)
    got = nwswg_records(cfg, p, t, pl, tl, packed)
    assert got.shape == (len(pl), nw.runs_lanes_nw(cfg))
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, want)
    if name.endswith("flag_heavy"):
        assert _flags(got).mean() > 0.9
    if name.endswith("main_bt"):
        assert not _flags(got).any()


@pytest.mark.parametrize("algo", ["nw", "swg"])
def test_reference_packed_equals_raw(algo):
    cfg = MAINS[algo]
    p, t, pl, tl = datagen_batch(256, seed=4)
    pp, pt, ok = common.pack_seqs(p, t, pl, tl, cfg.read_size)
    assert ok
    np.testing.assert_array_equal(nwswg_records(cfg, pp, pt, pl, tl, True),
                                  nwswg_records(cfg, p, t, pl, tl, False))


@pytest.mark.parametrize("algo,packed", [("nw", False), ("nw", True),
                                         ("swg", False), ("swg", True)])
def test_garbage_past_lengths_leaves_records(algo, packed):
    """Bytes past the lengths never reach a record, in the port and in the
    reference (2-bit packing carries the garbage into the packed words)."""
    cfg = MAINS[algo]
    p, t, pl, tl = datagen_batch(128, seed=9)
    gp, gt = garbage_padded(p, t, pl, tl)
    if packed:
        p, t, _ = common.pack_seqs(p, t, pl, tl, cfg.read_size)
        gp, gt, ok = common.pack_seqs(gp, gt, pl, tl, cfg.read_size)
        assert ok and (gp != p).any()
    clean = nwswg_records(cfg, p, t, pl, tl, packed)
    np.testing.assert_array_equal(nwswg_records(cfg, gp, gt, pl, tl, packed),
                                  clean)
    np.testing.assert_array_equal(_jax_records(cfg, gp, gt, pl, tl, packed),
                                  clean)


@pytest.mark.parametrize("name", ["nw_r40_unbal_bt", "swg_r40_unbal"])
def test_shuffled_pairs_permute_records(name):
    """Records are a per-pair function: the batch's longest text and the
    walk's tile-wide loop never leak into a pair's output."""
    cfg, p, t, pl, tl, _ = nwswg_case(name)
    want = _jax_records(cfg, p, t, pl, tl, False)
    perm = np.random.default_rng(0).permutation(len(pl))
    got = nwswg_records(cfg, p[perm], t[perm], pl[perm], tl[perm], False)
    np.testing.assert_array_equal(got, want[perm])
    for i in (0, 5, 77):
        one = nwswg_records(cfg, p[i:i + 1], t[i:i + 1], pl[i:i + 1],
                            tl[i:i + 1], False)
        np.testing.assert_array_equal(one[0], want[i])


def _oracle(cfg, p, t, pl, tl):
    return tapi._oracle_align(p, t, pl, tl, cfg)


@pytest.mark.parametrize("name", ["nw_main_bt", "swg_main_bt",
                                  "nw_r40_cheap_gaps", "swg_r40_unbal",
                                  "swg_int16", "nw_l128"])
def test_records_decode_to_oracle(name):
    """Unflagged pairs: scores from lane 1 and CIGARs through
    native.wfa_runs_to_ops equal the exact native oracle."""
    cfg, p, t, pl, tl, packed = nwswg_case(name)
    rec = nwswg_records(cfg, p, t, pl, tl, packed)
    sc = rec[:, 1].astype(np.int32)
    ok = ~_flags(rec)
    assert ok.mean() > 0.5
    ops, b, e = nat.wfa_runs_to_ops(rec, sc, pl, tl, max_score=1 << 30,
                                    max_ops=2 * cfg.read_size)
    osc, oops, ob, oe = _oracle(cfg, p, t, pl, tl)
    np.testing.assert_array_equal(sc[ok], osc[ok])
    for i in np.nonzero(ok)[0]:
        assert ops[i, b[i]:e[i]].tobytes() == oops[i, ob[i]:oe[i]].tobytes()


def _config_grid():
    for R in (8, 40, 112, 1120, 2040, 2048):
        for smax in range(0, 130, 9):
            for x, g in ((3, 4), (1, 1), (4, 1), (200, 150)):
                yield AlignConfig(algo="nw", read_size=R, max_score=smax,
                                  mismatch=x, gap_i=g, gap_d=g + 1)
            for m, x, o, e, var in ((0, 3, 4, 1, "vmem"), (0, 7, 2, 3, "hbm"),
                                    (-1, 2, 3, 1, "vmem"),
                                    (0, 5, 6, 2, "vmem")):
                yield AlignConfig(algo="swg", read_size=R, max_score=smax,
                                  match=m, mismatch=x, gap_o=o, gap_e=e,
                                  variant=var)


def test_geometry_and_gates_match_reference():
    n = 0
    for cfg in _config_grid():
        n += 1
        assert nw.band_geometry(cfg) == jnw.band_geometry(cfg), cfg
        assert nw.band_half(cfg) == jnw.band_half(cfg)
        assert nw.runs_lanes_nw(cfg) == jnw.runs_lanes_nw(cfg)
        assert nw.group_geom(cfg) == jnw.group_geom(cfg)
        for cost in (1, 2, 3, 150):
            assert nw.scan_rounds(cfg, cost) == jnw.scan_rounds(cfg, cost)
        assert kernels.long_fit_nwswg(cfg) == jlong.long_fit_nwswg(cfg)
        if cfg.algo == "nw":
            assert nw.vmem_fit_nw(cfg) == jnw.vmem_fit_nw(cfg), cfg
        else:
            assert swg.vmem_fit_swg(cfg) == jswg.vmem_fit_swg(cfg), cfg
            assert swg.swg_int8_sound(cfg) == jswg.swg_int8_sound(cfg), cfg
    assert n > 300


@pytest.mark.parametrize("algo", ["nw", "swg"])
def test_admission_matches_reference(algo):
    """A config lands on K2/K3 iff the reference's dispatch gives it the
    VMEM-tier Pallas kernel (pallas_kernels.py:101-135)."""
    seen = set()
    for cfg in _config_grid():
        if cfg.algo != algo:
            continue
        fn = jdispatch.forward_fn(cfg)
        # the streamed tier's callables carry their plane count
        j_vmem = fn is not None and not hasattr(fn, "primary_planes")
        try:
            tier = kernels.forward_fn(cfg)
            port = tier.forward is (nw.nw_forward if algo == "nw"
                                    else swg.swg_forward)
            assert tier.records == kernels.PACKED_RUNS
        except NotImplementedError as err:
            port = False
            item = "item 7" if fn is not None else "item 5"
            assert f"ROADMAP Queue 1 {item}" in str(err), (cfg, str(err))
        assert port == j_vmem, cfg
        seen.add(port)
    assert seen == {True, False}


@pytest.mark.parametrize("algo", ["nw", "swg"])
def test_cpu_wrapper_runs_plain_version_without_launch(algo):
    mod = nw if algo == "nw" else swg
    mod.reset_launch_count()
    cfg, p, t, pl, tl, _ = nwswg_case(f"{algo}_main_bt")
    got = nwswg_records(cfg, p, t, pl, tl, False, reference=False)
    np.testing.assert_array_equal(got, nwswg_records(cfg, p, t, pl, tl,
                                                     False))
    assert mod.launch_count == 0


@pytest.mark.parametrize("algo,bad", [
    (a, b) for a in ("nw", "swg")
    for b in ("pats_dtype", "lens_dtype", "rows", "widths", "gate")])
def test_wrapper_rejects_bad_inputs(algo, bad):
    p, t, pl, tl = (torch.from_numpy(a) for a in datagen_batch(8, seed=3))
    cfg = MAINS[algo]
    if bad == "pats_dtype":
        p = p.to(torch.int32)
    elif bad == "lens_dtype":
        pl = pl.to(torch.int64)
    elif bad == "rows":
        tl = tl[:4]
    elif bad == "widths":
        t = t[:, :50].contiguous()
    elif bad == "gate":
        cfg = cfg.replace(read_size=2504) if algo == "nw" \
            else cfg.replace(match=-1)
    fn = nw.nw_forward if algo == "nw" else swg.swg_forward
    with pytest.raises((TypeError, ValueError)):
        fn(p, t, pl, tl, cfg=cfg, packed=False)


def test_plan_uses_the_serving_kernel_footprint():
    """The chunk cap takes the per-pair device bytes of the kernel that
    serves the config: global plane scratch where shared memory is short."""
    cpu = torch.device("cpu")
    small = derive_config("nw", 100, 0.01, backtrace=True)
    big = AlignConfig(algo="nw", read_size=1120, max_score=120, gap_i=1,
                      gap_d=1, mismatch=1, backtrace=True)
    assert nw.planes_in_smem(small, 3) and not nw.planes_in_smem(big, 3)
    assert kernels.forward_fn(big).device_bytes_per_pair == \
        nw.device_bytes_per_pair(big) > 50_000
    assert tapi._memory_batch_cap(big, cpu, 1 << 30) < \
        tapi._memory_batch_cap(small, cpu, 1 << 30)
