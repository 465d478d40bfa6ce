"""The port's CUDA sources run on the CPU, against their plain versions.

g++ compiles ``aim_tpu_torch/csrc/*.cu`` with ``tests/torch_cuda_shim.h`` in
place of the CUDA runtime: one std::thread a GPU thread, the warp
collectives at a barrier a warp (the shim header says how).  The C entry
points are then called on CPU tensors with the arguments the wrappers pass
on the card, and the records must equal the plain PyTorch versions
byte for byte (tolerance: exact -- they are integers).  This reaches the
kernels' own code on a host without a GPU; the card runs them in
tests/test_torch_gpu.py and ``chip_smoke.py``.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from aim_tpu_torch.config import AlignConfig
from aim_tpu_torch.ops import (_build, common, genasm, nw, nwswg_long,
                               probes, swg, wfa2, wfa_long)
from torch_cases import (CASES, GENASM_CASES, WFA_LONG_CASES, case,
                         genasm_case, nwswg_case, nwswg_long_case,
                         nwswg_records, torch_records, wfa_long_case)

HERE = os.path.dirname(os.path.abspath(__file__))
LAUNCH = re.compile(r"(\w+)\s*<<<\s*([^,]+),\s*([^,]+),\s*([^,]+),.*?>>>"
                    r"\((\w+)\);", re.S)
SHARED = "extern __shared__ __align__(16) unsigned char smem[];"
# K2 and K3 at every band width (L 8, 16, 32 on the segmented path, 64 and
# 128 one pair a warp), with neighbours that differ in one warp, score only,
# and their planes in the global scratch
NWSWG = ["nw_main_bt", "swg_main_bt", "nw_edges", "swg_edges",
         "nw_ovf_check", "nw_l128", "swg_acgtn", "swg_main_nobt", "swg_l8",
         "swg_l32", "swg_int16", "swg_l128", "swg_mixed", "swg_r520_global",
         "nw_main_nobt", "nw_l8", "nw_l32", "nw_mixed", "nw_r800_global"]
NWSWG_LONG_SHIM = ["nw_p1_r200", "swg_p2_r200", "mixed_p1", "nw_multiblock",
                   "swg_wide_retry_p2", "nw_ovf_p1", "swg_multiblock"]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ (as aim_tpu.native does)")
    out = tmp_path_factory.mktemp("csrc_shim")
    (out / "cuda_runtime.h").write_text(
        f'#include "{os.path.join(HERE, "torch_cuda_shim.h")}"\n')
    jobs = []
    for path in _build.sources():
        text = open(path).read()
        text = LAUNCH.sub(r"shim::launch(\1, \2, \3, \4, \5);",
                          text.replace(SHARED,
                                       "unsigned char *smem = shim::smem();"))
        assert "<<<" not in text and "__shared__" not in text, path
        name = os.path.basename(path)
        if name.endswith(".cu"):
            name = name[:-3] + ".cpp"
        (out / name).write_text(text)
        if name.endswith(".cpp"):
            obj = out / (name + ".o")
            jobs.append((obj, subprocess.Popen(
                ["g++", "-std=c++20", "-O1", "-fPIC", "-pthread", f"-I{out}",
                 "-c", str(out / name), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for _, proc in jobs:
        log = proc.communicate()[0]
        assert proc.returncode == 0, log[-4000:]
    so = out / "libaimk_shim.so"
    r = subprocess.run(["g++", "-shared", "-pthread", "-o", str(so)]
                       + [str(obj) for obj, _ in jobs],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr[-4000:]
    return _build.declare(ctypes.CDLL(str(so)))


def _tensors(p, t, pl, tl, read_size, packed_ok=True):
    """The batch as the api hands it over: 2-bit packed when it packs."""
    pp, pt, packed = common.pack_seqs(p, t, pl, tl, read_size)
    if not (packed and packed_ok):
        pp, pt, packed = p, t, False
    T = torch.from_numpy
    return [T(np.ascontiguousarray(a)) for a in (
        pp, pt, np.asarray(pl, np.int32), np.asarray(tl, np.int32))], packed


def _call(fn, args, rec, scratch, *ints):
    rc = fn(*(a.data_ptr() for a in args), rec.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            args[0].shape[0], args[0].shape[1], *ints, None)
    assert rc == 0
    return rec.numpy()


def _records(n, cols, dtype=torch.int32):
    # a pattern the kernel must overwrite everywhere
    return torch.full((n, cols), -7, dtype=dtype)


@pytest.mark.parametrize("name", CASES)
def test_wfa2_cu_matches_plain_version(lib, name):
    cfg, p, t, pl, tl, packed = case(name)
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        p, t, np.asarray(pl, np.int32), np.asarray(tl, np.int32))]
    smax, _, Rp = wfa2._geometry(cfg)
    in_smem = wfa2.hist_in_smem(cfg)
    scratch = None if in_smem else torch.empty(
        (len(pl), wfa2.hist_bytes_per_pair(cfg) // 2), dtype=torch.int16)
    got = _call(lib.aim_wfa2_forward, args, _records(len(pl), smax + 4),
                scratch, int(packed), smax, Rp, cfg.mismatch, cfg.gap_o,
                cfg.gap_e, int(cfg.adaptive), int(cfg.backtrace),
                int(in_smem))
    np.testing.assert_array_equal(
        got, torch_records(wfa2.wfa2_reference, cfg, p, t, pl, tl, packed))


@pytest.mark.parametrize("name", NWSWG)
def test_band_cu_matches_plain_version(lib, name):
    cfg, p, t, pl, tl, packed = nwswg_case(name)
    mod = nw if cfg.algo == "nw" else swg
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        p, t, np.asarray(pl, np.int32), np.asarray(tl, np.int32))]
    C, L, _, NRL = nw.band_geometry(cfg)
    DS, costs = mod.kernel_args(cfg)
    in_smem, plane_bytes = mod.plane_layout(cfg)
    # the scratch starts as garbage, as torch.empty leaves it on the card
    scratch = None
    if cfg.backtrace and not in_smem:
        scratch = torch.full((len(pl), plane_bytes), 0xA5, dtype=torch.uint8)
    got = _call(getattr(lib, f"aim_{cfg.algo}_forward"), args,
                _records(len(pl), NRL, torch.int16), scratch, int(packed),
                cfg.read_size, C, L, NRL, DS, *costs, int(cfg.backtrace),
                int(in_smem))
    np.testing.assert_array_equal(
        got, nwswg_records(cfg, p, t, pl, tl, packed))


# (R, MAX_SCORE) of K2's layout grid: MAX_SCORE 2, 8, 20, 40 and 100 give
# band widths L = 8, 16, 32, 64 and 128 at the default costs
NW_LAYOUT_GRID = [(R, s) for R in (48, 112, 520, 800, 1520)
                  for s in (2, 8, 20, 40, 100)]


@pytest.mark.parametrize("R,max_score", NW_LAYOUT_GRID)
def test_nw_kernel_layout(lib, R, max_score):
    """ops/nw.py's mirrors of csrc/nw.cu's sizing: pairs a warp (32/L up to
    L = 32) and a block's shared memory (pattern, text and L-bit plane
    words a pair) as aim_nw_info reports them, with and without
    backtrace."""
    for bt in (True, False):
        cfg = AlignConfig(algo="nw", read_size=R, max_score=max_score,
                          backtrace=bt)
        L = nw.band_geometry(cfg)[1]
        out = (ctypes.c_int * len(_build.INFO_KEYS))()
        assert lib.aim_nw_info(R, L, int(bt), int(nw.planes_in_smem(cfg)),
                               out) == 0
        info = dict(zip(_build.INFO_KEYS, out))
        assert info["pairs_per_warp"] == nw.pairs_per_warp(cfg) == \
            (32 // L if L <= 32 else 1)
        assert info["smem_block_bytes"] == nw.WARPS * nw.warp_smem_bytes(
            cfg, nw.planes_in_smem(cfg))
        assert nw.plane_bytes_per_pair(cfg) == (R * 3 * L // 8 if bt else 0)
        assert nw.plane_layout(cfg) == (nw.planes_in_smem(cfg),
                                        nw.plane_bytes_per_pair(cfg))


@pytest.mark.parametrize("name", GENASM_CASES + ["r112_k7_bt"])
def test_genasm_cu_matches_plain_version(lib, name):
    cfg, p, t, pl, tl = genasm_case(name)
    args, packed = _tensors(p, t, pl, tl, cfg.read_size)
    assert packed
    R, k, _, _, Rp = genasm.geom(cfg)
    in_smem = genasm.hist_in_smem(cfg)
    scratch = None
    if cfg.backtrace and not in_smem:
        scratch = torch.full((len(pl), genasm.hist_bytes_per_pair(cfg) // 4),
                             -1, dtype=torch.int32)
    got = _call(lib.aim_genasm_forward, args, _records(len(pl), R + 4),
                scratch, R, k, Rp, int(cfg.backtrace), int(in_smem))
    np.testing.assert_array_equal(
        got, genasm.genasm_reference(*args, cfg=cfg).numpy())


@pytest.mark.parametrize("packed_ok", [True, False], ids=["packed", "bytes"])
@pytest.mark.parametrize("name", WFA_LONG_CASES)
def test_wfa_long_cu_matches_plain_version(lib, name, packed_ok):
    cfg, p, t, pl, tl = wfa_long_case(name)
    args, packed = _tensors(p, t, pl, tl, cfg.read_size, packed_ok)
    # the scratch starts as garbage, as torch.empty leaves it on the card
    scratch = torch.full((len(pl), wfa_long.hist_bytes_per_pair(cfg) // 2),
                         12345, dtype=torch.int16)
    got = _call(lib.aim_wfa_long_forward, args,
                _records(len(pl), cfg.max_score + 4), scratch, int(packed),
                cfg.max_score, cfg.read_size, cfg.mismatch, cfg.gap_o,
                cfg.gap_e, int(cfg.adaptive), int(cfg.backtrace))
    np.testing.assert_array_equal(
        got, wfa_long.wfa_long_reference(*args, cfg=cfg,
                                         packed=packed).numpy())


def _nwswg_long_check(lib, name, packed_ok):
    cfg, p, t, pl, tl, planes = nwswg_long_case(name)
    args, packed = _tensors(p, t, pl, tl, cfg.read_size, packed_ok)
    n, R = len(pl), cfg.read_size
    NRL = nwswg_long.runs_lanes_long(cfg)
    cb, ib = nwswg_long.row_bytes(cfg, planes)
    meta = torch.full((n, 2), -7, dtype=torch.int32)
    codes = torch.full((n, R, cb), 0xA5, dtype=torch.uint8)
    ism = torch.full((n, R, ib), 0x5A, dtype=torch.uint8)
    rec = _records(n, NRL, torch.int16)
    weff, lpad = nwswg_long.seq_geometry(cfg, args[0].shape[1], packed,
                                         planes)
    assert lib.aim_nwswg_long_forward(
        *(a.data_ptr() for a in args), meta.data_ptr(), codes.data_ptr(),
        ism.data_ptr(), rec.data_ptr(), n, args[0].shape[1], int(packed),
        weff, lpad, R, planes, NRL, int(cfg.algo == "swg"),
        int(cfg.backtrace), cfg.gap_i, cfg.gap_d, cfg.mismatch, cfg.match,
        cfg.gap_o, cfg.gap_e, cfg.max_score, None) == 0
    want_meta, want_codes, want_ism = nwswg_long.nwswg_long_fwd_reference(
        *args, cfg=cfg, packed=packed, planes=planes)
    np.testing.assert_array_equal(meta.numpy(), want_meta.numpy())
    if cfg.backtrace:
        # K6's code rows, every row a pair reaches (rows past its tlen are
        # never written nor read)
        live = np.arange(R)[None, :] < np.asarray(tl)[:, None]
        for got, want in ((codes, want_codes), (ism, want_ism)):
            np.testing.assert_array_equal(got.numpy()[live],
                                          want.numpy()[live])
        assert lib.aim_nwswg_long_walk(
            codes.data_ptr(), ism.data_ptr(), meta.data_ptr(),
            args[2].data_ptr(), args[3].data_ptr(), rec.data_ptr(), n, R,
            planes, NRL, nwswg_long.block_rows(cfg.algo, planes),
            int(cfg.algo == "swg"), None) == 0
    np.testing.assert_array_equal(
        rec.numpy(), nwswg_long.nwswg_forward_long(
            *args, cfg=cfg, packed=packed, planes=planes).numpy())


@pytest.mark.parametrize("name", NWSWG_LONG_SHIM)
def test_nwswg_long_cu_matches_plain_version(lib, name):
    """K6 + K7 (csrc/nwswg_long.cu) under the shim: meta, code rows and
    records equal to the plain versions, the code-row scratch starting as
    garbage; 2-bit packed input."""
    _nwswg_long_check(lib, name, True)


@pytest.mark.parametrize("name", ["nw_p1_r200", "swg_p2_r200", "mixed_p1"])
def test_nwswg_long_cu_raw_bytes(lib, name):
    """The same on raw bytes (the input of batches that do not pack)."""
    _nwswg_long_check(lib, name, False)


# every probe at 17 reps; M2 past its 60-row wrap; the while loop's
# tile-wide exit taken (one element starts past 10**6 - 20)
PROBE_SHIM = [(name, 17, None) for name in probes.PROBES] + [
    ("dynslice_hist_row", 64, None), ("while_loop", 40, "exit")]


@pytest.mark.parametrize("name,reps,variant", PROBE_SHIM,
                         ids=[f"{n}-{r}" + (f"-{v}" if v else "")
                              for n, r, v in PROBE_SHIM])
def test_probes_cu_matches_plain_version(lib, name, reps, variant):
    """M1/M2 (csrc/probes.cu) under the shim: outputs equal to the plain
    versions, the output starting as garbage."""
    args = list(probes.inputs(name))
    if variant == "exit":
        args[0] = args[0].clone()
        args[0][3, 5] = 10 ** 6 - 20
    pr = probes.PROBES[name]
    out = torch.full(pr.out_shape, -7, dtype=pr.dtype)
    assert lib.aim_probe(pr.index, args[0].data_ptr(),
                         args[1].data_ptr() if len(args) > 1 else None,
                         out.data_ptr(), reps, None) == 0
    want = probes.run(name, reps, *args)
    np.testing.assert_array_equal(out.numpy(), want.numpy())
    if variant == "exit":
        assert int(want.max()) >= 10 ** 6 and \
            int(want.max()) < 10 ** 6 - 20 + reps
