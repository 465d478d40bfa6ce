"""The frozen work counts of K1 and K5, on pairs worked by hand."""

import numpy as np
import pytest

import roofline
from reference import wfa

CARD = "NVIDIA H100 80GB HBM3"


def _pair(pat: bytes, txt: bytes, size=112):
    p = np.zeros((1, size), np.uint8)
    t = np.zeros((1, size), np.uint8)
    p[0, :len(pat)] = np.frombuffer(pat, np.uint8)
    t[0, :len(txt)] = np.frombuffer(txt, np.uint8)
    return p, t, np.array([len(pat)], np.int32), np.array([len(txt)],
                                                          np.int32)


def _cells(pat, txt):
    out = wfa.align(*_pair(pat, txt), mismatch=3, gap_opening=4,
                    gap_extending=1, max_score=5, adaptive=True)
    return int(out[0][0]), int(out[4][0])


PAT = b"ACGT" * 25


def test_bytes_by_hand():
    # 100 and 100 bases: 25 + 25 in, 4 score, 25 of CIGAR ops out
    assert roofline.wfa_bytes([100], [100]) == 79
    # 100 and 101: 25 + 26 in, 4, 26 out
    assert roofline.wfa_bytes([100], [101]) == 81
    assert roofline.wfa_bytes([100, 100], [99, 100]) == 79 + 79
    assert roofline.wfa_bytes([10000], [10030]) == 2500 + 2508 + 4 + 2508


def test_cells_and_ops_by_hand():
    # a mismatch: level 0 (one diagonal), level 3 (diagonals -1..1)
    mis = PAT[:50] + (b"T" if PAT[50:51] != b"T" else b"A") + PAT[51:]
    assert _cells(PAT, mis) == (3, 1 + 3)
    # an insertion: levels 0, 3 (the mismatch wavefront) and 5 (-1..1);
    # level 4 has no source, so no cells
    ins = PAT[:50] + b"A" + PAT[50:]
    assert _cells(PAT, ins) == (5, 1 + 3 + 3)
    assert _cells(PAT, PAT) == (0, 1)
    # 10 an op a cell, one a 32-base window of min(p, t) bases
    assert roofline.wfa_ops([100], [100], [4]) == 40 + 4
    assert roofline.wfa_ops([100], [101], [7]) == 70 + 4
    assert roofline.wfa_ops([100], [99], [7]) == 70 + 4
    assert roofline.wfa_ops([64], [65], [7]) == 70 + 2


def test_bound_and_share():
    b = roofline.bound_s(3.35e12, 0, CARD)
    assert b == pytest.approx(1.0)
    assert roofline.bound_s(0, 16.7e12, CARD) == pytest.approx(1.0)
    assert roofline.bound_s(1, 1, "some other card") is None

    class Entry:
        def work(self, unit):
            return (3.35e9, 0)             # 1 ms of bytes a batch

    class Run:
        pass

    run = Run()
    run.card = CARD
    run.entry = Entry()
    run.batches = [{"unit": 0}, {"unit": 1}]
    run.trace = {"device_s_by_name": {"void wfa2_kernel<16>(Params)": 0.004,
                                      "Memcpy HtoD": 1.0}}
    assert roofline.share(run, "wfa2_kernel") == pytest.approx(50.0)
    # no such kernel in the trace: nothing, never 0
    assert roofline.share(run, "wfa_long_kernel") is None
    run.trace = None
    assert roofline.share(run, "wfa2_kernel") is None
