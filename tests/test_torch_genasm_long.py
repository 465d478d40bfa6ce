"""The GenASM long tier (aim_tpu_torch/ops/genasm_long.py) and the
band-retry ladder (aim_tpu_torch/api.py ``_retry_stages`` /
``_retry_wide``) against the JAX package.

The tier's plain path must give records byte-equal to
``_genasm_long_jit(interpret=True)`` (tests/test_longread.py:224, :354),
its gates the reference's (:697); the ladder must parse
AIM_TPU_RETRY_PLANES as the reference does (:540) and, on the plain
versions, land the same scores, CIGARs, retry counts and still-flagged
pairs as ``aim_tpu.api._retry_wide`` (:304, :475, :582).  Tolerance:
exact.
"""

from dataclasses import replace
from functools import partial

import numpy as np
import pytest
import torch

import aim_tpu.native as nat
from aim_tpu import api as japi
from aim_tpu.config import AlignConfig
from aim_tpu.ops import genasm_long as jgl
from aim_tpu.ops.nwswg_pallas_long import nwswg_forward_pallas_long
from aim_tpu_torch import api as tapi
from aim_tpu_torch.ops import common, genasm_long, kernels, nwswg_long
from torch_cases import (GENASM_LONG_CASES, SWG_LONG, genasm_long_case,
                         wide_retry_batch)

T = torch.from_numpy


def _port(cfg, p, t, pl, tl, packed=False, planes=None):
    if packed:
        p, t = common.pack_seqs(p, t, pl, tl, cfg.read_size)[:2]
    return genasm_long.genasm_forward_long(
        T(np.ascontiguousarray(p)), T(np.ascontiguousarray(t)),
        T(np.ascontiguousarray(pl, np.int32)),
        T(np.ascontiguousarray(tl, np.int32)), cfg=cfg, packed=packed,
        planes=planes).numpy()


@pytest.mark.parametrize("name", GENASM_LONG_CASES)
def test_genasm_long_plain_matches_pallas_interpret(name):
    cfg, p, t, pl, tl = genasm_long_case(name)
    want = np.asarray(jgl.genasm_forward_pallas_long(
        p, t, pl.astype(np.int32), tl.astype(np.int32), cfg=cfg,
        interpret=True)["packed_runs"])
    got = _port(cfg, p, t, pl, tl)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_port(cfg, p, t, pl, tl, packed=True), got)
    sc = got[:, 1].astype(np.int32)
    fb = (got[:, 0].astype(np.int32) >> 8) & 1
    k = cfg.max_score
    if name.startswith("k40"):
        # out-of-band pair flagged; half-empty pairs patched, the second
        # past k rewritten; a certified overflow in the mix
        assert fb[-3] and not fb[-2:].any()
        assert list(sc[-2:]) == [37, k + 1]
        assert ((sc > k) & (fb == 0)).sum() >= 2
    else:
        assert genasm_long._npl(cfg) == 2 and not fb.any()
        assert (sc > 124).any() and sc[3] == k + 1


def test_genasm_long_decodes_to_oracle():
    cfg, p, t, pl, tl = genasm_long_case("k160_r640")
    rec = _port(cfg, p, t, pl, tl)
    sc = rec[:, 1].astype(np.int32)
    osc, oops, ob, oe = nat.genasm_align(p, t, pl, tl,
                                         max_score=cfg.max_score,
                                         backtrace=True)
    np.testing.assert_array_equal(sc, osc)
    ops, b, e = nat.wfa_runs_to_ops(rec, sc, pl, tl, max_score=1 << 30,
                                    max_ops=2 * cfg.read_size + 8)
    for i in range(len(pl)):
        assert ops[i, b[i]:e[i]].tobytes() == oops[i, ob[i]:oe[i]].tobytes()


def test_genasm_long_gates_match_reference():
    n = 0
    for R in (2, 100, 112, 792, 2048, 16352, 16360):
        for k in list(range(0, 600, 11)) + [26, 27, 124, 125, 252, 253, 508,
                                            509]:
            cfg = AlignConfig(algo="genasm", read_size=R, max_score=k,
                              backtrace=True)
            assert genasm_long.long_fit_genasm(cfg) == \
                jgl.long_fit_genasm(cfg), cfg
            assert kernels.long_fit_genasm(cfg) == jgl.long_fit_genasm(cfg)
            assert genasm_long._npl(cfg) == jgl._npl(cfg)
            assert genasm_long._nw_cfg(cfg).__dict__ == \
                jgl._nw_cfg(cfg).__dict__
            n += 1
    assert n > 400


class _JaxTier:
    retry_fn = staticmethod(lambda *a, **k: None)


class _JaxPrimary2(_JaxTier):
    primary_planes = 2


class _PortTier:
    retry = staticmethod(lambda *a, **k: None)


class _PortPrimary2(_PortTier):
    primary_planes = 2


@pytest.mark.parametrize("env", [None, "2,4,8", "2,4", "bogus", "2,64",
                                 "4,2,2", "", "2", " 8 , 2", "1,0", "x,4"])
def test_retry_stages_match_reference(monkeypatch, capsys, env):
    if env is None:
        monkeypatch.delenv("AIM_TPU_RETRY_PLANES", raising=False)
    else:
        monkeypatch.setenv("AIM_TPU_RETRY_PLANES", env)
    for jt, pt in ((_JaxTier(), _PortTier()),
                   (_JaxPrimary2(), _PortPrimary2()),
                   (object(), object())):
        capsys.readouterr()
        want = japi._retry_stages(jt)
        want_err = capsys.readouterr().err
        assert tapi._retry_stages(pt) == want
        assert capsys.readouterr().err == want_err  # the same warnings


def _tier(cfg, retry=None):
    """The port's tier for ``cfg``, its retry replaced by a stub if given
    (the ladder's memory cap stays the tier's own)."""
    tier = kernels.forward_fn(cfg)
    assert tier.retry is not None and tier.retry_bytes_per_pair is not None
    return tier if retry is None else replace(tier, retry=retry)


def _buffers(n, R):
    return (np.zeros(n, np.int32), np.zeros((n, 2 * R), np.uint8),
            np.zeros(n, np.int32), np.zeros(n, np.int32))


def test_retry_wide_plain_matches_reference():
    """tests/test_longread.py:304: four SWG pairs past the one-plane
    envelope certify on two planes, the aliasing pair stays flagged."""
    p, t, pl, tl = wide_retry_batch()
    cfg = AlignConfig(read_size=640, **SWG_LONG)
    first = nwswg_long.nwswg_forward_long(
        T(p), T(t), T(pl), T(tl), cfg=cfg).numpy()
    fb = ((first[:, 0].astype(np.int32) >> 8) & 1).astype(bool)
    assert fb[:4].all() and not fb[4] and fb[5]
    sel = np.nonzero(fb)[0]
    n, R = len(pl), cfg.read_size
    out = {}
    for who in ("jax", "port"):
        sc, ops, b, e = _buffers(n, R)
        if who == "jax":
            res = japi.AlignResult(sc, ops, b, e)
            left = japi._retry_wide(
                partial(nwswg_forward_pallas_long, interpret=True), cfg, p,
                t, pl, tl, sel, sc, ops, b, e, 0, 2 * R, lambda a: a, res)
        else:
            res = tapi.AlignResult(sc, ops, b, e)
            tier = _tier(cfg)
            assert tier.retry is nwswg_long.nwswg_forward_long
            left = tapi._retry_wide(tier, cfg, p, t, pl, tl, sel, sc, ops,
                                    b, e, 0, 2 * R, "cpu", res)
            assert res.retry_by_planes == {2: 4}
        out[who] = (list(left), res.n_retry, sc, ops, b, e)
    assert out["port"][:2] == out["jax"][:2] == ([5], 4)
    for a, b_ in zip(out["port"][2:], out["jax"][2:]):
        np.testing.assert_array_equal(a, b_)
    osc = nat.swg_align(p, t, pl, tl, match=0, mismatch=3, gap_o=4, gap_e=1,
                        max_score=400, cell_width=2, backtrace=True)[0]
    np.testing.assert_array_equal(out["port"][2][:4], osc[:4])


def _stub_pair(flag_first=False, by_planes=False):
    """The same stub retry tier for both packages: score 7 (or the plane
    count), the first pair of each batch flagged when asked."""
    def runs(m, planes):
        r = np.zeros((m, 256), np.int16)
        r[:, 0] = 254
        r[:, 1] = planes if by_planes else 7
        if flag_first:
            r[0, 0] |= 1 << 8
        if by_planes and planes == 2:
            r[:, 0] |= 1 << 8
        return r
    calls = {"jax": [], "port": []}

    def jax_stub(dp, dt, dpl, dtl, *, cfg, planes=2):
        # the reference pads batches to a power of two with empty pairs
        m = int((np.asarray(dpl) > 0).sum())
        calls["jax"].append((planes, m))
        return {"packed_runs": runs(len(dpl), planes)}

    def port_stub(dp, dt, dpl, dtl, *, cfg, planes=2):
        calls["port"].append((planes, len(dpl)))
        return torch.from_numpy(runs(len(dpl), planes))
    return jax_stub, port_stub, calls


def test_retry_wide_chunking_and_skip_match_reference():
    """tests/test_longread.py:475: host-computable skips (aliasing, skew
    past the band), the memory cap, still-flagged propagation."""
    n, R = 700, 576
    cfg = AlignConfig(algo="nw", read_size=R, max_score=300,
                      backtrace=False, gap_i=1, gap_d=1, mismatch=1)
    pl = np.full(n, 500, np.int32)
    tl = np.full(n, 500, np.int32)
    pl[5], tl[5] = 200, 100
    tl[6] = 700
    pats = np.zeros((n, R), np.uint8)
    jax_stub, port_stub, calls = _stub_pair(flag_first=True)
    jres = japi.AlignResult(np.zeros(n, np.int32), None, None, None)
    jleft = japi._retry_wide(jax_stub, cfg, pats, pats, pl, tl,
                             np.arange(n), jres.scores, None, None, None, 0,
                             2 * R, lambda a: a, jres)
    pres = tapi.AlignResult(np.zeros(n, np.int32), None, None, None)
    pleft = tapi._retry_wide(_tier(cfg, port_stub), cfg, pats, pats, pl, tl,
                             np.arange(n), pres.scores, None, None, None, 0,
                             2 * R, "cpu", pres)
    np.testing.assert_array_equal(pleft, jleft)
    assert 5 in pleft and 6 in pleft
    assert pres.n_retry == jres.n_retry == n - len(pleft)
    np.testing.assert_array_equal(pres.scores, jres.scores)
    assert calls["port"] == calls["jax"] == [(2, n - 2)]
    # a small memory budget splits the batch into power-of-two pieces
    calls["port"].clear()
    res = tapi.AlignResult(np.zeros(n, np.int32), None, None, None)
    per = _tier(cfg).retry_bytes_per_pair(2)
    assert per == nwswg_long.device_bytes_per_pair(cfg, 2)
    orig = tapi._device_memory_budget
    tapi._device_memory_budget = lambda device: 300 * per
    try:
        tapi._retry_wide(_tier(cfg, port_stub), cfg, pats, pats, pl, tl,
                         np.arange(n), res.scores, None, None, None, 0, 2 * R,
                         "cpu", res)
    finally:
        tapi._device_memory_budget = orig
    assert [m for _, m in calls["port"]] == [256, 256, 186]


def test_retry_ladder_escalation_matches_reference():
    """tests/test_longread.py:582: stage 2 certifies nothing and skips the
    pairs skewed past C = 127; stage 4 certifies all ten."""
    n, R = 10, 576
    cfg = AlignConfig(algo="nw", read_size=R, max_score=300,
                      backtrace=False, gap_i=1, gap_d=1, mismatch=1)
    pl = np.full(n, 300, np.int32)
    tl = np.full(n, 300, np.int32)
    tl[3], tl[7] = 450, 500
    pats = np.zeros((n, R), np.uint8)
    jax_stub, port_stub, calls = _stub_pair(by_planes=True)
    results = {}
    for who, stub in (("jax", jax_stub), ("port", _tier(cfg, port_stub))):
        mod = japi if who == "jax" else tapi
        res = mod.AlignResult(np.zeros(n, np.int32), None, None, None)
        sel = np.arange(n)
        for p in (2, 4):
            extra = (lambda a: a,) if who == "jax" else ("cpu",)
            sel = mod._retry_wide(stub, cfg, pats, pats, pl, tl, sel,
                                  res.scores, None, None, None, 0, 2 * R,
                                  *extra, res, planes=p)
        results[who] = (list(sel), res.n_retry, res.scores)
    assert results["port"][:2] == results["jax"][:2] == ([], n)
    np.testing.assert_array_equal(results["port"][2], results["jax"][2])
    assert (results["port"][2] == 4).all()
    assert calls["port"] == calls["jax"] == [(2, 8), (4, 10)]


def test_failed_retry_launch_raises():
    """A retry that fails raises: the port does not quietly hand the
    pairs to the host oracle."""
    n, R = 8, 576
    cfg = AlignConfig(algo="nw", read_size=R, max_score=300,
                      backtrace=False, gap_i=1, gap_d=1, mismatch=1)
    lens = np.full(n, 300, np.int32)
    pats = np.zeros((n, R), np.uint8)

    def broken(*a, **k):
        raise RuntimeError("K6 (nwswg_long forward) launch failed")
    res = tapi.AlignResult(np.zeros(n, np.int32), None, None, None)
    with pytest.raises(RuntimeError, match="launch failed"):
        tapi._retry_wide(_tier(cfg, broken), cfg, pats, pats, lens, lens,
                         np.arange(n), res.scores, None, None, None, 0, 2 * R,
                         "cpu", res)
