"""The port's CUDA kernels and CLI paths on the card (``gpu`` tests).

They skip on a host without CUDA.  This file imports no jax, so it also
runs on a GPU host without it; there, skip tests/conftest.py (which
imports jax to set up the JAX CPU mesh):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_gpu.py

Tolerance: exact (integer records, byte-identical files).
"""

import os

import numpy as np
import pytest
import torch

import aim_tpu_torch.native as nat
from aim_tpu_torch import api as tapi
from aim_tpu_torch import cli as tcli
from aim_tpu_torch import datagen
from aim_tpu_torch.cli import build_parser, config_from_args
from aim_tpu_torch.config import AlignConfig
from aim_tpu_torch.ops import (common, genasm, genasm_long, nw, nw_xla,
                               nwswg_long, probes, swg, swg_xla, wfa2,
                               wfa_long, wfa_xla)
from aim_tpu_torch.tools import fuzz_kernels, microbench, timing
from torch_cases import (CASES, DENSE_CASES, GENASM_CASES, GENASM_LONG_CASES,
                         K1_CASES, K7_CASES, MAIN, NWSWG_CASES,
                         NWSWG_LONG_CASES,
                         NWSWG_LONG_WIDE, SAMPLE_N, WFA_LONG_CASES, case,
                         datagen_batch, dense_batch, garbage_padded,
                         genasm_case, genasm_long_case, k1_case, nwswg_case,
                         nwswg_long_case, nwswg_records, wfa_long_case)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(REPO, "data", "sample-l100-e1-2K")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _kernel(dev, cfg, p, t, pl, tl, packed):
    args = common.to_device_batch(p, t, pl, tl, dev)
    out = wfa2.wfa_forward2(*args, cfg=cfg, packed=packed)
    torch.cuda.synchronize()
    return out.cpu().numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("name", CASES)
def test_cuda_kernel_matches_reference(cuda_device, name):
    cfg, p, t, pl, tl, packed = case(name)
    before = wfa2.launch_count
    got = _kernel(cuda_device, cfg, p, t, pl, tl, packed)
    assert wfa2.launch_count == before + 1
    args = common.to_device_batch(p, t, pl, tl, "cpu")
    want = wfa2.wfa2_reference(*args, cfg=cfg, packed=packed).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("name", K1_CASES)
def test_cuda_k1_path_matches_reference(cuda_device, name):
    """K1's paths on the card: two pairs a warp with neighbours that end
    apart, the odd batch's half-empty last warp, K = 15 and 17, the global
    history."""
    cfg, p, t, pl, tl, packed = k1_case(name)
    before = wfa2.launch_count
    got = _kernel(cuda_device, cfg, p, t, pl, tl, packed)
    assert wfa2.launch_count == before + 1
    args = common.to_device_batch(p, t, pl, tl, "cpu")
    want = wfa2.wfa2_reference(*args, cfg=cfg, packed=packed).numpy()
    np.testing.assert_array_equal(got, want)


# a history value above every real offset: a read of a cell outside the
# band a level wrote wins the walk's and the compute's maxima
POISON = 12345


def _wfa_poisoned(dev, mod, cfg, args, packed):
    """K1 (with its history in the global scratch) or K5 launched as its
    wrapper launches it, on a history scratch filled with POISON."""
    from aim_tpu_torch.ops import _build
    n = args[0].shape[0]
    smax = cfg.max_score
    rec = torch.full((n, smax + 4), -7, dtype=torch.int32, device=dev)
    scratch = torch.full((n, mod.hist_bytes_per_pair(cfg) // 2), POISON,
                         dtype=torch.int16, device=dev)
    ptrs = [a.data_ptr() for a in args] + [rec.data_ptr(),
                                           scratch.data_ptr()]
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.load()
    if mod is wfa2:
        rc = lib.aim_wfa2_forward(
            *ptrs, n, args[0].shape[1], int(packed), smax,
            wfa2._geometry(cfg)[2], cfg.mismatch, cfg.gap_o, cfg.gap_e,
            int(cfg.adaptive), int(cfg.backtrace), 0, stream)
    else:
        rc = lib.aim_wfa_long_forward(
            *ptrs, n, args[0].shape[1], int(packed), smax, cfg.read_size,
            cfg.mismatch, cfg.gap_o, cfg.gap_e, int(cfg.adaptive),
            int(cfg.backtrace), stream)
    torch.cuda.synchronize()
    assert rc == 0
    return rec.cpu().numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["k1_global_s79", "k1_mixed_bt"] + [
    f"{c}-{lay}" for c in WFA_LONG_CASES for lay in ("packed", "bytes")])
def test_cuda_wfa_poisoned_history(cuda_device, name):
    """K1 (history in the global scratch) and K5, adaptive (a narrow band)
    and not (the band fills K), 2-bit packed and raw bytes: records equal
    to the plain version on a history scratch that starts poisoned, so a
    read of a cell outside the band a level wrote would show."""
    if name.startswith("k1_"):
        cfg, p, t, pl, tl, packed = k1_case(name)
        mod = wfa2
    else:
        c, lay = name.rsplit("-", 1)
        cfg, p, t, pl, tl = wfa_long_case(c)
        mod = wfa_long
        packed = False
        if lay == "packed":
            p, t, packed = common.pack_seqs(p, t, pl, tl, cfg.read_size)
            if not packed:
                pytest.skip("the batch does not 2-bit pack (its bytes run)")
    args = common.to_device_batch(p, t, pl, tl, cuda_device)
    ref = wfa2.wfa2_reference if mod is wfa2 else wfa_long.wfa_long_reference
    want = ref(*common.to_device_batch(p, t, pl, tl, "cpu"), cfg=cfg,
               packed=packed).numpy()
    np.testing.assert_array_equal(
        _wfa_poisoned(cuda_device, mod, cfg, args, packed), want)


@pytest.mark.gpu
@pytest.mark.parametrize("name,ppw", [("main_bt", 2), ("k1_s7_odd", 2),
                                      ("k1_s8_odd", 1), ("r200_s25", 1),
                                      ("k1_global_s79", 1)])
def test_cuda_wfa_path(cuda_device, name, ppw):
    """K1's launch on the card: two pairs a warp where K <= 16, shared
    memory as ops/wfa2.py sizes it, at most 64 registers a thread, no
    spills, and at least 8 blocks an SM at the main config."""
    cfg = (k1_case if name.startswith("k1_") else case)(name)[0]
    info = wfa2.kernel_info(cfg)
    assert info["pairs_per_warp"] == ppw == wfa2.pairs_per_warp(cfg)
    assert info["smem_block_bytes"] == wfa2.block_smem_bytes(
        cfg, wfa2.hist_in_smem(cfg))
    assert info["registers"] <= 64 and info["local_bytes"] == 0
    if name == "main_bt":
        assert info["blocks_per_sm"] >= 8


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [True, False], ids=["packed", "bytes"])
def test_cuda_wfa_long_path(cuda_device, packed):
    """K5's launch at the 10 kbp config: one pair a warp, shared memory as
    ops/wfa_long.py sizes it, at most 64 registers, no spills, and at
    least 7 blocks an SM on 2-bit packed input."""
    cfg = wfa_long_case("l1000")[0].replace(read_size=10112, max_score=500)
    info = wfa_long.kernel_info(cfg, packed)
    assert info["pairs_per_warp"] == 1
    assert info["smem_block_bytes"] == \
        wfa_long.WARPS * wfa_long.warp_smem_bytes(cfg, packed)
    assert info["registers"] <= 64 and info["local_bytes"] == 0
    if packed:
        assert info["blocks_per_sm"] >= 7


@pytest.mark.gpu
def test_cuda_records_are_per_pair(cuda_device):
    """Any grouping of pairs into warps and blocks gives the same bytes:
    a shuffled batch gives the permuted records, one pair alone its row."""
    p, t, pl, tl = datagen_batch(4093, seed=11)
    t[::7] = t[::7][:, ::-1]          # overflowing pairs in the mix
    full = _kernel(cuda_device, MAIN, p, t, pl, tl, False)
    assert (full[:, MAIN.max_score + 3] > MAIN.max_score).any()
    perm = np.random.default_rng(1).permutation(len(pl))
    shuf = _kernel(cuda_device, MAIN, p[perm], t[perm], pl[perm], tl[perm],
                   False)
    np.testing.assert_array_equal(shuf, full[perm])
    for i in (0, 7, 4092):
        one = _kernel(cuda_device, MAIN, p[i:i + 1], t[i:i + 1],
                      pl[i:i + 1], tl[i:i + 1], False)
        np.testing.assert_array_equal(one[0], full[i])


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
def test_cuda_extend_bounds_come_from_lengths(cuda_device, packed):
    p, t, pl, tl = datagen_batch(4096, seed=9)
    gp, gt = garbage_padded(p, t, pl, tl)
    if packed:
        p, t, _ = common.pack_seqs(p, t, pl, tl, MAIN.read_size)
        gp, gt, _ = common.pack_seqs(gp, gt, pl, tl, MAIN.read_size)
    np.testing.assert_array_equal(
        _kernel(cuda_device, MAIN, gp, gt, pl, tl, packed),
        _kernel(cuda_device, MAIN, p, t, pl, tl, packed))


@pytest.mark.gpu
def test_cuda_wrapper_rejects_mixed_devices(cuda_device):
    p, t, pl, tl = common.to_device_batch(*datagen_batch(8, seed=3),
                                          cuda_device)
    with pytest.raises(ValueError):
        wfa2.wfa_forward2(p, t, pl.cpu(), tl, cfg=MAIN)


@pytest.mark.gpu
@pytest.mark.parametrize("flags", [["-b", "-r"], ["-b"], ["-r"]])
def test_cli_main_path_on_gpu(cuda_device, tmp_path, flags):
    out, ref = str(tmp_path / "gpu"), str(tmp_path / "oracle")
    argv = ["wfa", "-i", SAMPLE, "-l", "100", "-e", "0.01",
            "-n", str(SAMPLE_N)] + flags
    wfa2.reset_launch_count()
    assert tcli.main(argv + ["-o", out, "-q"]) == 0
    assert wfa2.launch_count > 0
    cfg = config_from_args(build_parser().parse_args(argv))
    p, t, pl, tl = nat.parse_pairs(SAMPLE, SAMPLE_N, cfg.read_size)
    sc, ops, b, e = nat.wfa_align(p, t, pl, tl, mismatch=cfg.mismatch,
                                  gap_o=cfg.gap_o, gap_e=cfg.gap_e,
                                  max_score=cfg.max_score,
                                  adaptive=cfg.adaptive,
                                  backtrace=cfg.backtrace)
    nat.emit_output(ref, np.arange(len(sc), dtype=np.int32), sc, ops, b, e,
                    cfg.backtrace)
    assert open(out, "rb").read() == open(ref, "rb").read()


def _band_kernel(dev, cfg, p, t, pl, tl, packed):
    mod = nw if cfg.algo == "nw" else swg
    args = common.to_device_batch(p, t, pl, tl, dev)
    before = mod.launch_count
    out = getattr(mod, f"{cfg.algo}_forward")(*args, cfg=cfg, packed=packed)
    torch.cuda.synchronize()
    assert mod.launch_count == before + 1
    return out.cpu().numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("name", NWSWG_CASES + ["swg_r520_global"])
def test_cuda_band_kernel_matches_reference(cuda_device, name):
    """K2/K3 records byte-equal to the plain version, flagged pairs too."""
    cfg, p, t, pl, tl, packed = nwswg_case(name)
    got = _band_kernel(cuda_device, cfg, p, t, pl, tl, packed)
    np.testing.assert_array_equal(got, nwswg_records(cfg, p, t, pl, tl,
                                                     packed))


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["nw", "swg"])
def test_cuda_band_records_are_per_pair(cuda_device, algo):
    """A shuffled batch gives the permuted records, one pair alone its row,
    and bytes past the lengths change nothing."""
    cfg = nwswg_case(f"{algo}_main_bt")[0]
    p, t, pl, tl = datagen_batch(4093, seed=11)
    t[::7] = t[::7][:, ::-1]          # flagged pairs in the mix
    full = _band_kernel(cuda_device, cfg, p, t, pl, tl, False)
    assert ((full[:, 0].astype(np.int32) >> 8) & 1).any()
    perm = np.random.default_rng(1).permutation(len(pl))
    shuf = _band_kernel(cuda_device, cfg, p[perm], t[perm], pl[perm],
                        tl[perm], False)
    np.testing.assert_array_equal(shuf, full[perm])
    for i in (0, 7, 4092):
        one = _band_kernel(cuda_device, cfg, p[i:i + 1], t[i:i + 1],
                           pl[i:i + 1], tl[i:i + 1], False)
        np.testing.assert_array_equal(one[0], full[i])
    gp, gt = garbage_padded(p, t, pl, tl)
    np.testing.assert_array_equal(
        _band_kernel(cuda_device, cfg, gp, gt, pl, tl, False), full)


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["nw", "swg"])
def test_cli_nwswg_on_gpu(cuda_device, tmp_path, algo):
    """`nw -b` / `swg -b` on the sample: cmp-equal to the oracle, through
    the kernel, no pair flagged."""
    mod = nw if algo == "nw" else swg
    out, ref, log = (str(tmp_path / f) for f in ("gpu", "oracle", "log"))
    argv = [algo, "-i", SAMPLE, "-l", "100", "-e", "0.01",
            "-n", str(SAMPLE_N), "-b"]
    mod.reset_launch_count()
    assert tcli.main(argv + ["-o", out, "--device-log", log, "-q"]) == 0
    assert mod.launch_count > 0
    assert "fallback=0" in open(log).read()
    cfg = config_from_args(build_parser().parse_args(argv))
    p, t, pl, tl = nat.parse_pairs(SAMPLE, SAMPLE_N, cfg.read_size)
    sc, ops, b, e = tapi._oracle_align(p, t, pl, tl, cfg)
    nat.emit_output(ref, np.arange(len(sc), dtype=np.int32), sc, ops, b, e,
                    cfg.backtrace)
    assert open(out, "rb").read() == open(ref, "rb").read()


def _k45(dev, mod, cfg, p, t, pl, tl, reference=False):
    """K4 (genasm) or K5 (wfa_long) on the batch as the api hands it over:
    2-bit packed when it packs, else raw bytes (K5 only)."""
    pp, pt, packed = common.pack_seqs(p, t, pl, tl, cfg.read_size)
    if not packed:
        pp, pt = p, t
    fwd, ref = ((genasm.genasm_forward, genasm.genasm_reference)
                if mod is genasm else
                (wfa_long.wfa_forward_long, wfa_long.wfa_long_reference))
    args = common.to_device_batch(pp, pt, pl, tl, dev)
    before = mod.launch_count
    out = (ref if reference else fwd)(*args, cfg=cfg, packed=packed)
    torch.cuda.synchronize()
    assert mod.launch_count == before + (0 if reference else 1)
    return out.cpu().numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("name", GENASM_CASES + ["r112_k7_bt"])
def test_cuda_genasm_matches_reference(cuda_device, name):
    """K4 records byte-equal to the plain version, overflow pairs too."""
    cfg, p, t, pl, tl = genasm_case(name)
    np.testing.assert_array_equal(
        _k45(cuda_device, genasm, cfg, p, t, pl, tl),
        _k45(cuda_device, genasm, cfg, p, t, pl, tl, reference=True))


@pytest.mark.gpu
@pytest.mark.parametrize("name,ppw,windowed", [
    ("main_bt", 2, True), ("r16_k5_edges_bt", 4, True),
    ("r112_k5_bt", 1, True), ("r24_k10_bt", 2, False),
    ("r32_k12_bt", 1, False), ("r64_k26_bt", 1, False)])
def test_cuda_genasm_path(cuda_device, name, ppw, windowed):
    """K4's launch on the card: pairs a warp and the windowed history as
    ops/genasm.py sizes them, at most 64 registers a thread and no spills
    on the segmented path, and at least 8 blocks an SM there."""
    cfg = genasm_case(name)[0]
    info = genasm.kernel_info(cfg)
    assert (info["pairs_per_warp"], bool(info["hist_windowed"])) == \
        (ppw, windowed) == (genasm.pairs_per_warp(cfg),
                            genasm.hist_windowed(cfg))
    assert info["smem_block_bytes"] == \
        genasm.WARPS * genasm.warp_smem_bytes(cfg, genasm.hist_in_smem(cfg))
    if genasm.seg_lanes(cfg):
        assert info["registers"] <= 64 and info["local_bytes"] == 0
        assert info["blocks_per_sm"] >= 8


@pytest.mark.gpu
@pytest.mark.parametrize("name,ppw", [("swg_main_bt", 2), ("swg_l8", 4),
                                      ("swg_l32", 1), ("swg_int16", 1),
                                      ("swg_l128", 1)])
def test_cuda_swg_path(cuda_device, name, ppw):
    """K3's launch on the card: 32/L pairs a warp up to L = 32, shared
    memory as ops/swg.py sizes it, at most 64 registers a thread and no
    spills on the segmented path."""
    cfg = nwswg_case(name)[0]
    info = swg.kernel_info(cfg)
    assert info["pairs_per_warp"] == ppw == swg.pairs_per_warp(cfg)
    assert info["smem_block_bytes"] == \
        nw.WARPS * swg.warp_smem_bytes(cfg, swg.planes_in_smem(cfg))
    if ppw > 1 or nw.band_geometry(cfg)[1] == 32:
        assert info["registers"] <= 64 and info["local_bytes"] == 0
        assert info["blocks_per_sm"] >= 8


@pytest.mark.gpu
@pytest.mark.parametrize("name,ppw", [("nw_main_bt", 2), ("nw_l8", 4),
                                      ("nw_l32", 1), ("nw_r800_global", 2),
                                      ("nw_l128", 1)])
def test_cuda_nw_path(cuda_device, name, ppw):
    """K2's launch on the card: 32/L pairs a warp up to L = 32, shared
    memory as ops/nw.py sizes it, at most 64 registers a thread, no spills
    and at least 8 blocks an SM on the segmented path."""
    cfg = nwswg_case(name)[0]
    info = nw.kernel_info(cfg)
    assert info["pairs_per_warp"] == ppw == nw.pairs_per_warp(cfg)
    assert info["smem_block_bytes"] == \
        nw.WARPS * nw.warp_smem_bytes(cfg, nw.planes_in_smem(cfg))
    if nw.band_geometry(cfg)[1] <= 32:
        assert info["registers"] <= 64 and info["local_bytes"] == 0
        assert info["blocks_per_sm"] >= 8


@pytest.mark.gpu
@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("algo", ["nw", "swg"])
def test_cuda_nwswg_long_registers(cuda_device, algo, planes):
    """K6 at one and two planes: at most 64 registers a thread and no
    spills, so 8 blocks of 4 warps fit an SM (a 4096-pair chunk in one
    wave on 132 SMs)."""
    info = nwswg_long.kernel_info(derive_long(algo), planes)
    assert info["registers"] <= 64 and info["local_bytes"] == 0
    assert info["blocks_per_sm"] >= 8 and info["pairs_per_warp"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("algo", ["nw", "swg"])
def test_cuda_nwswg_long_walk_registers(cuda_device, algo, planes):
    """K7 at one and two planes (its is-match window in registers): at most
    64 registers a thread and no spills, so a 4096-pair chunk walks in one
    wave too."""
    info = nwswg_long.kernel_info(derive_long(algo), planes, walk=True)
    assert info["registers"] <= 64 and info["local_bytes"] == 0
    assert info["blocks_per_sm"] >= 8 and info["pairs_per_warp"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("name", WFA_LONG_CASES)
def test_cuda_wfa_long_matches_reference(cuda_device, name):
    """K5 records byte-equal to the plain version, both word layouts."""
    cfg, p, t, pl, tl = wfa_long_case(name)
    np.testing.assert_array_equal(
        _k45(cuda_device, wfa_long, cfg, p, t, pl, tl),
        _k45(cuda_device, wfa_long, cfg, p, t, pl, tl, reference=True))


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["genasm", "wfa_long"])
def test_cuda_k45_records_are_per_pair(cuda_device, which):
    """A shuffled batch gives the permuted records, one pair alone its row,
    and bytes past the lengths change nothing."""
    mod = genasm if which == "genasm" else wfa_long
    cfg, p, t, pl, tl = (genasm_case("overflow_bt") if which == "genasm"
                         else wfa_long_case("mixed_r520_s50"))
    full = _k45(cuda_device, mod, cfg, p, t, pl, tl)
    perm = np.random.default_rng(1).permutation(len(pl))
    np.testing.assert_array_equal(
        _k45(cuda_device, mod, cfg, p[perm], t[perm], pl[perm], tl[perm]),
        full[perm])
    for i in (0, 7):
        one = _k45(cuda_device, mod, cfg, p[i:i + 1], t[i:i + 1],
                   pl[i:i + 1], tl[i:i + 1])
        np.testing.assert_array_equal(one[0], full[i])
    gp, gt = garbage_padded(p, t, pl, tl)
    np.testing.assert_array_equal(_k45(cuda_device, mod, cfg, gp, gt, pl, tl),
                                  full)


@pytest.mark.gpu
@pytest.mark.parametrize("flags", [["-b"], []])
def test_cli_genasm_on_gpu(cuda_device, tmp_path, flags):
    """`genasm -b` / `genasm` on the sample: cmp-equal to the oracle,
    through K4 alone."""
    out, ref = str(tmp_path / "gpu"), str(tmp_path / "oracle")
    argv = ["genasm", "-i", SAMPLE, "-l", "100", "-e", "0.01",
            "-n", str(SAMPLE_N)] + flags
    for mod in (genasm, wfa2, nw, swg, wfa_long, nwswg_long):
        mod.reset_launch_count()
    assert tcli.main(argv + ["-o", out, "-q"]) == 0
    assert genasm.launch_count > 0
    assert wfa2.launch_count == nw.launch_count == swg.launch_count == \
        wfa_long.launch_count == nwswg_long.launch_count == 0
    cfg = config_from_args(build_parser().parse_args(argv))
    p, t, pl, tl = nat.parse_pairs(SAMPLE, SAMPLE_N, cfg.read_size)
    sc, ops, b, e = nat.genasm_align(p, t, pl, tl, max_score=cfg.max_score,
                                     backtrace=cfg.backtrace)
    nat.emit_output(ref, np.arange(len(sc), dtype=np.int32), sc, ops, b, e,
                    cfg.backtrace)
    assert open(out, "rb").read() == open(ref, "rb").read()


def derive_long(algo):
    from aim_tpu_torch.config import derive_config
    return derive_config(algo, 1500, 0.01, backtrace=True, variant="hbm")


def _long(dev, cfg, p, t, pl, tl, planes, packed, reference=False):
    """K6 + K7 (or their plain versions) on the batch, 2-bit packed or raw;
    returns the records and the launches of K6 and K7."""
    if packed:
        p, t = common.pack_seqs(p, t, pl, tl, cfg.read_size)[:2]
    args = common.to_device_batch(p, t, pl, tl, dev)
    nwswg_long.reset_launch_count()
    if reference:
        meta, codes, ism = nwswg_long.nwswg_long_fwd_reference(
            *args, cfg=cfg, packed=packed, planes=planes)
        out = (nwswg_long.nwswg_long_walk_reference(
            codes, ism, meta, args[2], args[3], cfg=cfg, planes=planes)
            if cfg.backtrace else
            nwswg_long.score_only_records(meta,
                                          nwswg_long.runs_lanes_long(cfg)))
    else:
        out = nwswg_long.nwswg_forward_long(*args, cfg=cfg, packed=packed,
                                            planes=planes)
    torch.cuda.synchronize()
    return out.cpu().numpy(), (nwswg_long.launch_count,
                               nwswg_long.walk_launch_count)


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True], ids=["raw", "packed"])
@pytest.mark.parametrize("name", NWSWG_LONG_CASES + NWSWG_LONG_WIDE +
                         ["nw_ovf_p1"] + K7_CASES)
def test_cuda_nwswg_long_matches_reference(cuda_device, name, packed):
    """K6/K7 records byte-equal to the plain versions on the card, flagged
    pairs, planes 1 to 8, NRL 256 to 1024, score-only runs and K7's own
    cases (torch_cases.K7_CASES) included."""
    cfg, p, t, pl, tl, planes = nwswg_long_case(name)
    got, launches = _long(cuda_device, cfg, p, t, pl, tl, planes, packed)
    assert launches == (1, int(cfg.backtrace))
    want, none = _long(cuda_device, cfg, p, t, pl, tl, planes, packed,
                       reference=True)
    assert none == (0, 0)
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["nw", "swg"])
def test_cuda_nwswg_long_records_are_per_pair(cuda_device, algo):
    """A shuffled batch gives the permuted records, one pair alone its row,
    and bytes past the lengths change nothing."""
    cfg = derive_long(algo)
    p, t, pl, tl = datagen.generate_pairs(509, 1500, 0.01,
                                          read_size=cfg.read_size, seed=5)
    full, _ = _long(cuda_device, cfg, p, t, pl, tl, 1, False)
    assert ((full[:, 0].astype(np.int32) >> 8) & 1).any()
    perm = np.random.default_rng(1).permutation(len(pl))
    shuf, _ = _long(cuda_device, cfg, p[perm], t[perm], pl[perm], tl[perm],
                    1, False)
    np.testing.assert_array_equal(shuf, full[perm])
    for i in (0, 7, 508):
        one, _ = _long(cuda_device, cfg, p[i:i + 1], t[i:i + 1],
                       pl[i:i + 1], tl[i:i + 1], 1, False)
        np.testing.assert_array_equal(one[0], full[i])
    gp, gt = garbage_padded(p, t, pl, tl)
    np.testing.assert_array_equal(
        _long(cuda_device, cfg, gp, gt, pl, tl, 1, False)[0], full)


@pytest.mark.gpu
@pytest.mark.parametrize("name", GENASM_LONG_CASES)
def test_cuda_genasm_long_matches_reference(cuda_device, name):
    """The GenASM long tier on the card (K6/K7 and the rewrite on the
    device) equals it on CPU tensors."""
    cfg, p, t, pl, tl = genasm_long_case(name)
    args = common.to_device_batch(p, t, pl, tl, cuda_device)
    nwswg_long.reset_launch_count()
    got = genasm_long.genasm_forward_long(*args, cfg=cfg).cpu().numpy()
    assert nwswg_long.launch_count == 1
    cpu = common.to_device_batch(p, t, pl, tl, "cpu")
    np.testing.assert_array_equal(
        got, genasm_long.genasm_forward_long(*cpu, cfg=cfg).numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("argv,n,gen_err,env", [
    (["nw", "-l", "1500", "-e", "0.01", "-b", "--variant", "hbm"], 300,
     0.01, {}),
    (["swg", "-l", "1000", "-e", "0.01", "-b", "--variant", "hbm"], 300,
     0.01, {}),
    (["swg", "-l", "1000", "-e", "0.03", "-b", "--variant", "hbm"], 300,
     0.05, {"AIM_TPU_ROUTE": "0"}),
    (["genasm", "-l", "600", "-e", "0.05", "-b"], 300, 0.05, {}),
    (["nw", "-l", "1500", "-e", "0.01", "--variant", "hbm"], 300, 0.01, {}),
    # 10 % errors against K2's band at 100 bp: the ladder re-runs the
    # flagged pairs on K6/K7 at two planes
    (["nw", "-l", "100", "-e", "0.01", "-b"], 300, 0.1, {}),
], ids=["nw-b", "swg-b", "swg-b-route0", "genasm-b", "nw", "nw-100-ladder"])
def test_cli_long_tiers_on_gpu(cuda_device, tmp_path, monkeypatch, argv, n,
                               gen_err, env):
    """The streamed NW/SWG and GenASM long tiers, and K2's retry ladder on
    them, file to file: cmp-equal to the oracle, through K6 (and K7 with
    -b)."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    src, out, ref = (str(tmp_path / f) for f in ("pairs", "gpu", "oracle"))
    datagen.write_pair_file(src, n, int(argv[2]), gen_err, seed=3)
    argv = argv[:1] + ["-i", src, "-n", str(n)] + argv[1:]
    nwswg_long.reset_launch_count()
    assert tcli.main(argv + ["-o", out, "-q"]) == 0
    assert nwswg_long.launch_count > 0
    assert nwswg_long.walk_launch_count == (nwswg_long.launch_count
                                            if "-b" in argv else 0)
    cfg = config_from_args(build_parser().parse_args(argv))
    p, t, pl, tl = nat.parse_pairs(src, n, cfg.read_size)
    sc, ops, b, e = tapi._oracle_align(p, t, pl, tl, cfg)
    nat.emit_output(ref, np.arange(len(sc), dtype=np.int32), sc, ops, b, e,
                    cfg.backtrace)
    assert open(out, "rb").read() == open(ref, "rb").read()


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(probes.PROBES))
def test_cuda_probe_matches_plain_version(cuda_device, name):
    """M1/M2 (csrc/probes.cu) on the card: equal to the plain version at 0,
    17 and 64 reps (M2 past its 60-row wrap), one launch a call."""
    for reps in (0, 17, 64):
        args = probes.inputs(name, cuda_device)
        before = probes.launch_counts[name]
        got = probes.run(name, reps, *args)
        torch.cuda.synchronize()
        assert probes.launch_counts[name] == before + 1
        want = probes.PROBES[name].plain(reps, *(a.cpu() for a in args))
        assert got.dtype == want.dtype
        assert torch.equal(got.cpu(), want), (name, reps)


@pytest.mark.gpu
def test_cuda_probe_while_loop_exit(cuda_device):
    """The while loop's tile-wide exit (__syncthreads_or) taken."""
    x = probes.inputs("while_loop")[0].clone()
    x[3, 5] = 10 ** 6 - 20
    got = probes.run("while_loop", 40, x.to(cuda_device)).cpu()
    want = probes.run("while_loop", 40, x)
    assert torch.equal(got, want) and int(want.max()) < 10 ** 6 + 1


@pytest.mark.gpu
def test_microbench_and_cuda_event_timing(cuda_device):
    m = microbench.measure("i32_min_128x128", cuda_device)
    assert m["ms_512"] > 0 and m["ms_64"] > 0 and m["plain_ms_512"] > 0
    assert m["bound_ns_per_rep"] > 0
    args = probes.inputs("popcount", cuda_device)
    t = timing.best_of(lambda: probes.run("popcount", 512, *args),
                       device=cuda_device, min_anchor_s=1e-6)
    ba, bb, _, _ = timing.interleaved_ab(
        lambda: probes.run("popcount", 64, *args),
        lambda: probes.run("popcount", 512, *args), rounds=3,
        device=cuda_device, min_anchor_s=1e-6)
    assert t > 0 and bb > 0 and ba > 0


DENSE_FWD = {"nw": nw_xla.nw_forward, "swg": swg_xla.swg_forward,
             "wfa": wfa_xla.wfa_forward}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(DENSE_CASES))
def test_cuda_dense_tier_matches_cpu(cuda_device, name):
    """The dense tiers on the card equal them on CPU tensors (where the CPU
    tests hold them to JAX's XLA tier)."""
    algo, R, kw, alphabet = DENSE_CASES[name]
    cfg = AlignConfig(algo=algo, read_size=R, **kw)
    batch = dense_batch(R, alphabet)
    got = DENSE_FWD[algo](*common.to_device_batch(*batch, cuda_device),
                          cfg=cfg)
    want = DENSE_FWD[algo](*common.to_device_batch(*batch, "cpu"), cfg=cfg)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("row", [0, 3, 5, 6, 14, 26, 27])
def test_cuda_fuzz_rows(cuda_device, row):
    """Fuzz rows of every short tier (K1, K2, K4, dense SWG) on the card,
    cut to 512 pairs: 0 bad pairs against the oracle."""
    cut = fuzz_kernels.CONFIGS[row][:4] + (512,) + \
        fuzz_kernels.CONFIGS[row][5:]
    bad, rep = fuzz_kernels.run_one(cut, 101, device=cuda_device)
    assert bad == 0, rep


@pytest.mark.gpu
@pytest.mark.parametrize("flags,dense", [
    (["wfa", "-b", "-r", "--backend", "xla"], wfa_xla),
    (["nw", "-b", "--backend", "xla"], nw_xla),
    (["swg", "-m", "-1", "-b"], swg_xla),
], ids=["wfa-b-r-xla", "nw-b-xla", "swg-m-1"])
def test_cli_dense_on_gpu(cuda_device, tmp_path, flags, dense):
    """The dense tiers through the CLI on the card: cmp-equal to the
    oracle, no hand kernel launched."""
    out, ref = str(tmp_path / "gpu"), str(tmp_path / "oracle")
    argv = flags[:1] + ["-i", SAMPLE, "-l", "100", "-e", "0.01",
                        "-n", str(SAMPLE_N)] + flags[1:]
    kmods = (wfa2, nw, swg, genasm, wfa_long, nwswg_long)
    for mod in kmods:
        mod.reset_launch_count()
    dense.reset_call_count()
    assert tcli.main(argv + ["-o", out, "-q"]) == 0
    assert dense.call_count > 0
    assert all(mod.launch_count == 0 for mod in kmods)
    cfg = config_from_args(build_parser().parse_args(argv))
    p, t, pl, tl = nat.parse_pairs(SAMPLE, SAMPLE_N, cfg.read_size)
    if cfg.algo == "wfa":
        sc, ops, b, e = nat.wfa_align(p, t, pl, tl, mismatch=cfg.mismatch,
                                      gap_o=cfg.gap_o, gap_e=cfg.gap_e,
                                      max_score=cfg.max_score,
                                      adaptive=cfg.adaptive,
                                      backtrace=cfg.backtrace)
    else:
        sc, ops, b, e = tapi._oracle_align(p, t, pl, tl, cfg)
    nat.emit_output(ref, np.arange(len(sc), dtype=np.int32), sc, ops, b, e,
                    cfg.backtrace)
    assert open(out, "rb").read() == open(ref, "rb").read()


@pytest.mark.gpu
def test_cli_profile_and_energy_on_gpu(cuda_device, tmp_path, capsys):
    """--profile leaves a chrome trace of the whole call with K1's kernel
    events, each launched inside an ``aim.kernel`` range, and ``aim.parse``
    and ``aim.emit`` inside ``aim.call``; --energy prints the GPU energy
    NVML measured (or says it was not measured)."""
    import json
    prof = tmp_path / "prof"
    argv = ["wfa", "-i", SAMPLE, "-l", "100", "-e", "0.01", "-n",
            str(SAMPLE_N), "-b", "-r", "-o", str(tmp_path / "o"),
            "--profile", str(prof), "--energy"]
    assert tcli.main(argv) == 0
    events = json.load(open(prof / "trace.json"))["traceEvents"]
    kernels = [e for e in events
               if e.get("cat") == "kernel" and "wfa2" in e.get("name", "")]
    assert kernels

    def ranges(name):
        return [(e["ts"], e["ts"] + e["dur"]) for e in events
                if e.get("ph") == "X" and e.get("name") == name]

    # a kernel's launch (the host event of its correlation id) lies in
    # an aim.kernel range
    launch = {(e.get("args") or {}).get("correlation"): e["ts"]
              for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")}
    inside = ranges("aim.kernel")
    for k in kernels:
        ts = launch[k["args"]["correlation"]]
        assert any(a <= ts <= b for a, b in inside)
    (c0, c1), = ranges("aim.call")
    for name in ("aim.parse", "aim.emit"):
        (a, b), = ranges(name)
        assert c0 <= a and b <= c1
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("GPU Energy")]
    assert len(line) == 1
    if "not measured" not in line[0]:
        assert float(line[0].rsplit(":", 1)[1]) >= 0


@pytest.mark.gpu
@pytest.mark.parametrize("algo,mod", [("wfa", wfa2), ("nw", nw)],
                         ids=["K1", "K2"])
def test_cuda_sharded_align_equals_one_device(cuda_device, algo, mod):
    """Two shards on one card (``[cuda:0] * 2``): the same scores and
    CIGARs as one device; one launch a non-empty block."""
    from aim_tpu_torch.config import derive_config
    cfg = derive_config(algo, 100, 0.01, backtrace=True,
                        adaptive=algo == "wfa").replace(batch_pairs=1024)
    p, t, pl, tl = datagen.generate_pairs(2600, 100, 0.01,
                                          read_size=cfg.read_size, seed=11)
    res = {}
    for shards in (1, 2):
        mod.reset_launch_count()
        res[shards] = tapi.align(p, t, pl, tl, cfg, [cuda_device] * shards)
        # 2600 pairs in chunks of 1024: 3 chunks; two shards a chunk
        # leave the tail's 552 pairs one block of 512 and one of 40
        assert mod.launch_count == 3 * shards
    for k in ("scores", "ops", "begin", "end"):
        np.testing.assert_array_equal(getattr(res[2], k), getattr(res[1], k))
    assert res[2].n_fallback == res[1].n_fallback


@pytest.mark.gpu
def test_cuda_missing_card_raises(cuda_device):
    p, t, pl, tl = datagen_batch(8, seed=3)
    with pytest.raises(RuntimeError):
        tapi.align(p, t, pl, tl, MAIN, [cuda_device, torch.device(
            "cuda", torch.cuda.device_count())])
