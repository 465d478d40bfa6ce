"""The plain reference against the program's native oracle (a C++ port of
the AIM reference's WFA): every pair's score and CIGAR ops equal, on the
AIM sample pairs checked into `data/` and on generated 10 kbp pairs.
The reference never imports the oracle; only this test reads both."""

import json
import os

import numpy as np
import pytest

import gen
from reference import emit, wfa

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
SAMPLE = os.path.join(ROOT, "data", "sample-l100-e1-2K")


def _config(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return json.load(f)


def _parse(path, size, n):
    """The first `n` pairs of a `>pattern` / `<text` file."""
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    pats = np.zeros((n, size), np.uint8)
    txts = np.zeros((n, size), np.uint8)
    plens = np.zeros(n, np.int32)
    tlens = np.zeros(n, np.int32)
    for i in range(n):
        p, t = lines[2 * i][1:], lines[2 * i + 1][1:]
        pats[i, :len(p)] = np.frombuffer(p, np.uint8)
        txts[i, :len(t)] = np.frombuffer(t, np.uint8)
        plens[i], tlens[i] = len(p), len(t)
    return pats, txts, plens, tlens


def _pairs(name, n):
    c = _config(name)
    if name == "wfa_adaptive_l100_e1":
        return c, _parse(SAMPLE, c["read_size"], n)
    return c, gen.generate(n, c["read_length"], c["error"], 2**33 + 5, 0,
                           size=c["read_size"])


@pytest.mark.parametrize("name,n", [("wfa_adaptive_l100_e1", 1000),
                                    ("wfa_adaptive_l10k_e1", 6)])
def test_reference_equals_native_oracle(name, n):
    nat = pytest.importorskip("aim_tpu_torch.native")
    c, (pats, txts, plens, tlens) = _pairs(name, n)
    ref = wfa.run(pats, txts, plens, tlens, c)
    osc, oops, ob, oe = nat.wfa_align(
        pats, txts, plens, tlens, mismatch=c["mismatch"],
        gap_o=c["gap_opening"], gap_e=c["gap_extending"],
        max_score=c["max_score"], adaptive=c["adaptive"], backtrace=True)
    np.testing.assert_array_equal(ref[0], osc)
    for i in range(n):
        assert emit.segment(ref[1][i], int(ref[2][i]), int(ref[3][i])) == \
            emit.segment(oops[i], int(ob[i]), int(oe[i])), i
