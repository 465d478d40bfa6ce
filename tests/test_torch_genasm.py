"""K4 of the PyTorch port (aim_tpu_torch/ops/genasm.py) against the JAX
reference kernel.

The same numpy inputs go through the reference Pallas kernel
``aim_tpu.ops.genasm_pallas.genasm_forward_pallas`` in interpret mode and
through the port's plain PyTorch version; the records must be byte-equal
(tolerance: exact -- they are integers).  The CUDA kernel is held to the
same plain version on the card (tests/test_torch_gpu.py and
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import aim_tpu.native as nat
from aim_tpu.config import AlignConfig
from aim_tpu.ops import genasm_pallas as jref
from aim_tpu_torch.ops import genasm
from torch_cases import (GENASM_CASES, GENASM_MAIN, datagen_batch,
                         garbage_padded, genasm_case, packed_case,
                         torch_records)


def _jax_records(cfg, p, t, pl, tl):
    out = jref.genasm_forward_pallas(p, t, pl, tl, cfg=cfg, interpret=True)
    return np.asarray(out["genasm_records"])


def _torch_records(cfg, p, t, pl, tl, fn=genasm.genasm_reference):
    pp, pt = packed_case(p, t, pl, tl, cfg.read_size)
    return torch_records(fn, cfg, pp, pt, pl, tl, True)


@pytest.mark.parametrize("name", GENASM_CASES)
def test_reference_matches_pallas_interpret(name):
    cfg, p, t, pl, tl = genasm_case(name)
    want = _jax_records(cfg, p, t, pl, tl)
    got = _torch_records(cfg, p, t, pl, tl)
    R, k = cfg.read_size, cfg.max_score
    assert got.shape == (len(pl), R + 4)
    np.testing.assert_array_equal(got, want)
    over = got[:, R + 3] > k
    if name.startswith("overflow"):
        assert over.sum() > 10
    # overflow pairs: score k+1 and the oracle's single-'M' record, in
    # score-only mode too
    assert (got[over, R + 3] == k + 1).all()
    assert (got[over, R + 1] == 1).all()


@pytest.mark.parametrize("name", ["r32_k12_bt", "r16_k5_edges_bt",
                                  "main_bt", "overflow_bt"])
def test_records_decode_to_oracle(name):
    """Scores and CIGARs through native.wfa_steps_to_ops(max_score=R)
    equal the exact GenASM oracle."""
    cfg, p, t, pl, tl = genasm_case(name)
    R = cfg.read_size
    rec = _torch_records(cfg, p, t, pl, tl)
    sc, ops, b, e = nat.wfa_steps_to_ops(rec, pl, tl, max_score=R,
                                         max_ops=2 * R)
    osc, oops, ob, oe = nat.genasm_align(p, t, pl, tl,
                                         max_score=cfg.max_score,
                                         backtrace=True)
    np.testing.assert_array_equal(sc, osc)
    for i in range(len(pl)):
        assert ops[i, b[i]:e[i]].tobytes() == oops[i, ob[i]:oe[i]].tobytes()


def test_reference_is_per_pair_and_ignores_padding():
    """Records are a per-pair function (the TPU tile ran to its longest
    text; the port stops each pair at its own), and bytes past the lengths
    change nothing."""
    cfg, p, t, pl, tl = genasm_case("overflow_bt")
    want = _torch_records(cfg, p, t, pl, tl)
    perm = np.random.default_rng(0).permutation(len(pl))
    np.testing.assert_array_equal(
        _torch_records(cfg, p[perm], t[perm], pl[perm], tl[perm]),
        want[perm])
    for i in (0, 9):
        one = _torch_records(cfg, p[i:i + 1], t[i:i + 1], pl[i:i + 1],
                             tl[i:i + 1])
        np.testing.assert_array_equal(one[0], want[i])
    gp, gt = garbage_padded(p, t, pl, tl)
    np.testing.assert_array_equal(_torch_records(cfg, gp, gt, pl, tl), want)


def test_gate_and_geometry_match_reference():
    for R in range(8, 1001, 8):
        for k in list(range(0, 30)) + [40, 64]:
            cfg = AlignConfig(algo="genasm", read_size=R, max_score=k)
            assert genasm.vmem_fit_genasm(cfg) == jref.vmem_fit_genasm(cfg), \
                (R, k)
            assert genasm.ref_geom(cfg) == jref._geom(cfg)
        assert genasm.genasm_record_rows(R) == jref.genasm_record_rows(R)
    # the k edge (k < 27) and the memory edge at the main width
    assert genasm.vmem_fit_genasm(GENASM_MAIN.replace(max_score=26))
    assert not genasm.vmem_fit_genasm(GENASM_MAIN.replace(max_score=27))
    assert not genasm.vmem_fit_genasm(GENASM_MAIN.replace(read_size=800,
                                                          max_score=0))
    # the port's 32-bit layout: Wg words a group cover bits 0..R+1
    for R in (16, 24, 32, 112, 792):
        _, _, Wg, DW, Rp = genasm.geom(GENASM_MAIN.replace(read_size=R))
        assert 32 * (Wg - 1) < R + 2 <= 32 * Wg and Rp >= R + 2


def test_history_placement():
    """The main config keeps its history in shared memory (5.4 KB a pair);
    the k edge needs the global scratch; score-only keeps none."""
    assert genasm.hist_bytes_per_pair(GENASM_MAIN) == 113 * 12 * 4
    assert genasm.hist_in_smem(GENASM_MAIN)
    edge = AlignConfig(algo="genasm", read_size=64, max_score=26,
                       backtrace=True)
    assert not genasm.hist_in_smem(edge)
    assert genasm.device_bytes_per_pair(edge) > \
        genasm.hist_bytes_per_pair(edge)
    assert genasm.device_bytes_per_pair(edge.replace(backtrace=False)) < \
        genasm.hist_bytes_per_pair(edge)


def test_cpu_wrapper_runs_plain_version_without_launch():
    genasm.reset_launch_count()
    cfg, p, t, pl, tl = genasm_case("r32_k12_bt")
    np.testing.assert_array_equal(
        _torch_records(cfg, p, t, pl, tl, fn=genasm.genasm_forward),
        _torch_records(cfg, p, t, pl, tl))
    assert genasm.launch_count == 0


@pytest.mark.parametrize("bad", ["unpacked", "gate", "lens_dtype", "rows"])
def test_wrapper_rejects_bad_inputs(bad):
    p, t, pl, tl = datagen_batch(8, seed=3)
    pp, pt = packed_case(p, t, pl, tl, 112)
    pp, pt, pl, tl = (torch.from_numpy(np.ascontiguousarray(a))
                      for a in (pp, pt, pl, tl))
    cfg, packed = GENASM_MAIN, True
    if bad == "unpacked":
        packed = False
    elif bad == "gate":
        cfg = GENASM_MAIN.replace(max_score=27)
    elif bad == "lens_dtype":
        pl = pl.to(torch.int64)
    elif bad == "rows":
        tl = tl[:4]
    with pytest.raises((TypeError, ValueError)):
        genasm.genasm_forward(pp, pt, pl, tl, cfg=cfg, packed=packed)
