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

from aim_tpu_torch.ops import _build, common, genasm, nw, swg, wfa2, wfa_long
from torch_cases import (CASES, GENASM_CASES, WFA_LONG_CASES, case,
                         genasm_case, nwswg_case, nwswg_records,
                         torch_records, wfa_long_case)

HERE = os.path.dirname(os.path.abspath(__file__))
LAUNCH = re.compile(r"(\w+)\s*<<<\s*([^,]+),\s*([^,]+),\s*([^,]+),.*?>>>"
                    r"\((\w+)\);", re.S)
SHARED = "extern __shared__ __align__(16) unsigned char smem[];"
NWSWG = ["nw_main_bt", "swg_main_bt", "nw_edges", "swg_edges",
         "nw_ovf_check", "nw_l128", "swg_acgtn"]


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
    n_planes = 3 if cfg.algo == "nw" else swg.N_PLANES
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        p, t, np.asarray(pl, np.int32), np.asarray(tl, np.int32))]
    C, L, _, NRL = nw.band_geometry(cfg)
    DS, costs = mod.kernel_args(cfg)
    in_smem = nw.planes_in_smem(cfg, n_planes)
    scratch = None
    if cfg.backtrace and not in_smem:
        scratch = torch.empty(
            (len(pl), nw.plane_bytes_per_pair(cfg, n_planes) // 4),
            dtype=torch.int32)
    got = _call(getattr(lib, f"aim_{cfg.algo}_forward"), args,
                _records(len(pl), NRL, torch.int16), scratch, int(packed),
                cfg.read_size, C, L, NRL, DS, *costs, int(cfg.backtrace),
                int(in_smem))
    np.testing.assert_array_equal(
        got, nwswg_records(cfg, p, t, pl, tl, packed))


@pytest.mark.parametrize("name", GENASM_CASES)
def test_genasm_cu_matches_plain_version(lib, name):
    cfg, p, t, pl, tl = genasm_case(name)
    args, packed = _tensors(p, t, pl, tl, cfg.read_size)
    assert packed
    R, k, _, _, Rp = genasm.geom(cfg)
    in_smem = genasm.hist_in_smem(cfg)
    scratch = None
    if cfg.backtrace and not in_smem:
        scratch = torch.empty((len(pl), genasm.hist_bytes_per_pair(cfg) // 4),
                              dtype=torch.int32)
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
