"""The pair generator: determinism per seed, datagen's edit semantics,
and the pair-file grammar."""

import math

import numpy as np
import pytest

import gen


def _parse(path):
    """A plain parser of the `>pattern\\n<text\\n` grammar."""
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    assert lines[-1] == b""
    lines = lines[:-1]
    assert all(a.startswith(b">") for a in lines[0::2])
    assert all(b.startswith(b"<") for b in lines[1::2])
    return [a[1:] for a in lines[0::2]], [b[1:] for b in lines[1::2]]


def test_same_seed_same_pairs():
    a = gen.generate(300, 100, 0.01, 2**33 + 5, size=112)
    b = gen.generate(300, 100, 0.01, 2**33 + 5, size=112)
    c = gen.generate(300, 100, 0.01, 2**33 + 6, size=112)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], c[0])


def test_pairs_do_not_depend_on_the_threads():
    a = gen.generate(70000, 100, 0.01, 21, size=112, workers=1)
    b = gen.generate(70000, 100, 0.01, 21, size=112, workers=8)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_streams_differ():
    a = gen.generate(50, 100, 0.01, 11, 0)
    b = gen.generate(50, 100, 0.01, 11, 1)
    assert not np.array_equal(a[0], b[0])


@pytest.mark.parametrize("length,error", [(100, 0.01), (1000, 0.01),
                                          (200, 0.05)])
def test_edits_as_datagen_makes_them(length, error):
    n = 600
    pats, txts, plens, tlens, (pos, kinds) = gen.generate(
        n, length, error, 7, with_edits=True)
    n_err = math.ceil(length * error)
    assert pos.shape == kinds.shape == (n, n_err)
    assert (plens == length).all()
    n_ins = (kinds == gen.INSERTION).sum(1)
    n_del = (kinds == gen.DELETION).sum(1)
    np.testing.assert_array_equal(tlens, length + n_ins - n_del)
    # uniform types
    share = np.bincount(kinds.ravel(), minlength=3) / kinds.size
    assert np.all(np.abs(share - 1 / 3) < 0.05)
    # each pair's edits sit at distinct positions; rebuild every text
    for i in range(n):
        assert len(set(pos[i].tolist())) == n_err
        pat = pats[i, :length].tobytes()
        by_pos = dict(zip(pos[i].tolist(), kinds[i].tolist()))
        txt = txts[i, :tlens[i]].tobytes()
        j = 0
        for p in range(length):
            kind = by_pos.get(p)
            if kind == gen.INSERTION:
                assert txt[j:j + 1] in (b"A", b"C", b"G", b"T")
                j += 1
            if kind == gen.DELETION:
                continue
            if kind == gen.MISMATCH:
                assert txt[j] != pat[p]          # a real edit
            else:
                assert txt[j] == pat[p]
            j += 1
        assert j == tlens[i]
        assert not pats[i, length:].any() and not txts[i, tlens[i]:].any()


def test_length_spread_matches_datagen():
    """At one edit a pair, datagen's and this generator's text lengths
    follow one distribution: a third each at l - 1, l and l + 1."""
    from aim_tpu_torch import datagen
    n = 3000
    _, _, _, tl = gen.generate(n, 100, 0.01, 3)
    _, _, _, tl2 = datagen.generate_pairs(n, 100, 0.01, seed=3)
    h1 = np.bincount(tl - 99, minlength=3) / n
    h2 = np.bincount(tl2 - 99, minlength=3) / n
    assert np.all(np.abs(h1 - h2) < 0.05)


def test_file_round_trip(tmp_path):
    pats, txts, plens, tlens = gen.generate(257, 150, 0.02, 5, size=160)
    path = str(tmp_path / "pairs.txt")
    size = gen.write_pairs(path, pats, txts, plens, tlens)
    assert size == (tmp_path / "pairs.txt").stat().st_size
    ps, ts = _parse(path)
    assert len(ps) == 257
    for i in range(257):
        assert ps[i] == pats[i, :plens[i]].tobytes()
        assert ts[i] == txts[i, :tlens[i]].tobytes()


def test_file_parsed_by_the_program(tmp_path):
    from aim_tpu_torch import native
    data = gen.generate(500, 100, 0.01, 9, size=112)
    path = str(tmp_path / "pairs.txt")
    gen.write_pairs(path, *data)
    got = native.parse_pairs(path, 10**6, 112)
    for x, y in zip(got, data):
        np.testing.assert_array_equal(x, y)
