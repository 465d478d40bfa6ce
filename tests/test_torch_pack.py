"""The port's pack pass (``aim_tpu_torch.native.pack_seqs``: one fused
pass that reads each row once, on row ranges across threads) against the
JAX package's native packer, which it must equal byte for byte in both
outputs and the ``ok`` flag, and against the port's NumPy fallback
(``ops.common.pack_seqs`` without the native library), which codes the
same batch through a sorted LUT: the fused ACGT code, relabelled field by
field to that LUT, equals it byte for byte.  Also the thread rule
(``ops.common._pack_threads``) and the ``pack_threads`` counter.
"""

import os

import numpy as np
import pytest

import aim_tpu.native as jnat
from aim_tpu_torch import api as tapi
from aim_tpu_torch import native as tnat
from aim_tpu_torch import spans
from aim_tpu_torch.config import derive_config
from aim_tpu_torch.ops import common

THREADS = (1, 2, 3, 7)
SAMPLE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "sample-l100-e1-2K")


def _rp(read_size):
    return -(-(read_size + 2) // 8) * 8


def _batch(n, read_size, alphabet=b"ACGT", seed=0, past=b""):
    """``n`` ragged pairs of ``alphabet``; bytes past plen/tlen are 0, or
    drawn from ``past``."""
    rng = np.random.default_rng(seed)
    a = np.frombuffer(alphabet, np.uint8)
    pats = a[rng.integers(0, len(a), (n, read_size))]
    txts = a[rng.integers(0, len(a), (n, read_size))]
    plens = rng.integers(0, read_size + 1, n).astype(np.int32)
    tlens = rng.integers(0, read_size + 1, n).astype(np.int32)
    pos = np.arange(read_size)
    for arr, lens in ((pats, plens), (txts, tlens)):
        pad = pos >= lens[:, None]
        if past:
            b = np.frombuffer(past, np.uint8)
            arr[pad] = b[rng.integers(0, len(b), int(pad.sum()))]
        else:
            arr[pad] = 0
    return pats, txts, plens, tlens


def _fallback(monkeypatch, pats, txts, plens, tlens, read_size):
    with monkeypatch.context() as m:
        m.setattr(tnat, "available", lambda: False)
        return common.pack_seqs(pats, txts, plens, tlens, read_size)


def _relabel(packed, pats, txts, plens, tlens):
    """The fused pass's ACGT code ((c >> 1) & 3) as the fallback's sorted
    LUT codes it: each 2-bit field mapped, the padding code 0 kept."""
    seen = np.zeros(256, bool)
    seen[pats.reshape(-1)] = True
    seen[txts.reshape(-1)] = True
    seen[0] = False
    code = np.zeros(4, np.uint8)
    for rank, c in enumerate(np.nonzero(seen)[0]):
        code[(c >> 1) & 3] = rank
    byte = np.arange(256)
    lut = sum(code[(byte >> (2 * q)) & 3].astype(np.int64) << (2 * q)
              for q in range(4)).astype(np.uint8)
    return lut[packed]


def _check(monkeypatch, batch, read_size, threads, fused):
    """The port's pack at ``threads`` equals the JAX package's byte for
    byte; ``fused`` says whether the fused ACGT pass should take it."""
    pats, txts, plens, tlens = batch
    rp = _rp(read_size)
    pp, pt, ok, used = tnat.pack_seqs(pats, txts, plens, tlens, rp,
                                      threads)
    jp, jt, jok = jnat.pack_seqs(pats, txts, plens, tlens, rp)
    assert ok == jok
    np.testing.assert_array_equal(pp, jp)
    np.testing.assert_array_equal(pt, jt)
    n = len(pats)
    step = -(-n // threads) if n else 1
    assert used == (-(-n // step) if fused and n else 0)
    fp, ft, fok = _fallback(monkeypatch, pats, txts, plens, tlens,
                            read_size)
    assert fok == ok
    if fused:
        pp = _relabel(pp, pats, txts, plens, tlens)
        pt = _relabel(pt, pats, txts, plens, tlens)
    np.testing.assert_array_equal(pp, fp)
    np.testing.assert_array_equal(pt, ft)
    return ok


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("read_size", (7, 112, 120, 128, 10112))
@pytest.mark.parametrize("n", (0, 1, 63, 64, 1000))
def test_fused_pass_equals_reference(monkeypatch, n, read_size, threads):
    if read_size == 10112:
        n = min(n, 64)  # 1,000 rows at 10 kbp: the ragged case at 112-128
    batch = _batch(n, read_size, seed=n * 31 + read_size)
    assert _check(monkeypatch, batch, read_size, threads, fused=True)


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("alphabet,ok", [
    (b"ACGTN", False),   # five symbols: not packable
    (b"acgt", True),     # lowercase: the generic path's four symbols
    (b"ACG", True),      # three of ACGT: still the fused pass
    (b"ACGTacgt", False),
])
def test_other_alphabets(monkeypatch, alphabet, ok, threads):
    batch = _batch(1000, 120, alphabet, seed=len(alphabet))
    fused = alphabet == b"ACG"
    assert _check(monkeypatch, batch, 120, threads, fused) == ok


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("odd,ok", [(b"N", True), (b"T", True),
                                    (b"a", True), (b"\x00", False)])
def test_byte_outside_acgt_in_the_last_range(monkeypatch, odd, ok, threads):
    """One byte inside the last row's valid region sends the whole batch
    to the generic path (ACG plus one more symbol: four, so it packs; an
    interior NUL refuses the batch); a T keeps the fused pass."""
    pats, txts, plens, tlens = _batch(1000, 112, b"ACG", seed=5)
    plens[-1] = 100
    pats[-1, :100] = np.frombuffer(b"ACG" * 34, np.uint8)[:100]
    pats[-1, 57] = odd[0]
    fused = odd == b"T"
    assert _check(monkeypatch, (pats, txts, plens, tlens), 112, threads,
                  fused) == ok


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("past", (b"ACGT", bytes(range(1, 256))))
def test_bytes_past_the_lengths(monkeypatch, past, threads):
    """Non-zero bytes past plen/tlen are packed as they stand and never
    checked: the fused pass keeps the batch.  The fallback counts them in
    its alphabet, so it is held to the JAX package only on ACGT bytes."""
    batch = _batch(1000, 112, seed=9, past=past)
    rp = _rp(112)
    pp, pt, ok, used = tnat.pack_seqs(*batch, rp, threads)
    jp, jt, jok = jnat.pack_seqs(*batch, rp)
    assert ok and jok and used >= 1
    np.testing.assert_array_equal(pp, jp)
    np.testing.assert_array_equal(pt, jt)
    if past == b"ACGT":
        _check(monkeypatch, batch, 112, threads, fused=True)


def test_thread_rule(monkeypatch):
    m = common.PACK_MIN_BYTES
    monkeypatch.setattr(common.os, "cpu_count", lambda: 8)
    assert common._pack_threads(0, 112) == 1
    # below twice the minimum: the calling thread alone
    assert common._pack_threads((2 * m - 1) // 224, 112) == 1
    assert common._pack_threads(2 * m // 224 + 1, 112) == 2
    assert common._pack_threads(10 ** 6, 112) == min(8, 224 * 10 ** 6 // m)
    assert common._pack_threads(10 ** 4, 10112) == 8
    monkeypatch.setattr(common.os, "cpu_count", lambda: 64)
    assert common._pack_threads(10 ** 4, 10112) == 16


def test_pack_threads_counter():
    cfg = derive_config("wfa", 100, 0.01, backtrace=True, adaptive=True)
    R = cfg.read_size
    pats, txts, plens, tlens = tnat.parse_pairs(SAMPLE, 400, R)
    res = tapi.align(pats, txts, plens, tlens, cfg, "cpu")
    assert res.spans.counts["pack_threads"] == common._pack_threads(400, R)
    assert spans.calls()[-1]["pack_threads"] == common._pack_threads(400, R)
    # the generic path packs, the fused pass does not: 0
    odd = pats.copy()
    odd[0, 0] = ord("N")
    res = tapi.align(odd, txts, plens, tlens, cfg, "cpu")
    assert res.spans.counts["pack_threads"] == 0
    # an empty batch packs nothing
    e = np.zeros((0, R), np.uint8)
    z = np.zeros(0, np.int32)
    with spans.call("align", 0) as rec:
        assert common.pack_seqs(e, e, z, z, R)[2]
    assert rec.counts["pack_threads"] == 0
    assert tapi.align(e, e, z, z, cfg, "cpu").spans.counts[
        "pack_threads"] == 0
