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

import aim_tpu.native as nat
from aim_tpu.cli import build_parser, config_from_args
from aim_tpu_torch import api as tapi
from aim_tpu_torch import cli as tcli
from aim_tpu_torch.ops import common, genasm, nw, swg, wfa2, wfa_long
from torch_cases import (CASES, GENASM_CASES, MAIN, NWSWG_CASES, SAMPLE_N,
                         WFA_LONG_CASES, case, datagen_batch, garbage_padded,
                         genasm_case, nwswg_case, nwswg_records,
                         wfa_long_case)

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
@pytest.mark.parametrize("name", NWSWG_CASES)
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
@pytest.mark.parametrize("name", GENASM_CASES)
def test_cuda_genasm_matches_reference(cuda_device, name):
    """K4 records byte-equal to the plain version, overflow pairs too."""
    cfg, p, t, pl, tl = genasm_case(name)
    np.testing.assert_array_equal(
        _k45(cuda_device, genasm, cfg, p, t, pl, tl),
        _k45(cuda_device, genasm, cfg, p, t, pl, tl, reference=True))


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
    for mod in (genasm, wfa2, nw, swg, wfa_long):
        mod.reset_launch_count()
    assert tcli.main(argv + ["-o", out, "-q"]) == 0
    assert genasm.launch_count > 0
    assert wfa2.launch_count == nw.launch_count == swg.launch_count == \
        wfa_long.launch_count == 0
    cfg = config_from_args(build_parser().parse_args(argv))
    p, t, pl, tl = nat.parse_pairs(SAMPLE, SAMPLE_N, cfg.read_size)
    sc, ops, b, e = nat.genasm_align(p, t, pl, tl, max_score=cfg.max_score,
                                     backtrace=cfg.backtrace)
    nat.emit_output(ref, np.arange(len(sc), dtype=np.int32), sc, ops, b, e,
                    cfg.backtrace)
    assert open(out, "rb").read() == open(ref, "rb").read()
