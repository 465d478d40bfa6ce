"""The port's pair parser (``aim_tpu_torch.native.parse_pairs``: one pass
over a read-only map of the file, its bytes split into ranges across
threads) against the JAX package's sequential parser,
``aim_tpu.native.parse_pairs(..., threads=1)``: the arrays, the lengths
and the pair count, the errors and their text.  Also the thread rule
(``native.parse_threads``) and the ``parse_threads`` counter.  Tolerance:
exact.
"""

import os

import numpy as np
import pytest

import aim_tpu.native as jnat
from aim_tpu_torch import api as tapi
from aim_tpu_torch import native as tnat
from aim_tpu_torch.config import derive_config

THREADS = (1, 2, 3, 7, 16)
R = 12
SAMPLE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "sample-l100-e1-2K")


def _seq(rng, n):
    return "".join(rng.choice(list("ACGT"), n)) if n else ""


def _pairs(lens, seed=0, eol="\n", last_eol=True):
    """A file of ``>pattern`` / ``<text`` lines of the given (plen, tlen)
    lengths."""
    rng = np.random.default_rng(seed)
    lines = []
    for p, t in lens:
        lines += [">" + _seq(rng, p), "<" + _seq(rng, t)]
    return (eol.join(lines) + (eol if last_eol else "")).encode()


CASES = {
    # two ranges meet at len // 2: in a line, on a '\n', on each sentinel
    "split_in_line": b">ACGTACGT\n<ACGTAC\n>AC\n<ACG\n",
    "split_on_newline": b">ACGT\n<ACG\n>AC\n<ACGT\n",
    "split_on_pattern_sentinel": b">ACGT\n<ACGTA\n>ACGTA\n<ACGT\n",
    "split_on_text_sentinel": b">ACGT\n<ACG\n>ACG\n<ACGTAC\n>ACG\n<AC\n",
    # pairs wider than a range at 7 and 16 threads
    "spanning_pairs": _pairs([(R, R), (0, R), (R, 1), (R - 1, R)]),
    "no_final_newline": _pairs([(4, 5), (6, 6), (2, 3)], last_eol=False),
    "crlf": _pairs([(4, 5), (R - 1, R - 1), (0, 3)], eol="\r\n"),
    # empty lines and sentinel-only lines
    "empty_lines": b"\n\n>\n<\n>AC\n\n\n<G\n",
    "odd_lines": _pairs([(4, 5), (6, 6)]) + b">ACG\n",
    "odd_lines_no_final_newline": _pairs([(4, 5), (6, 6)]) + b">ACG",
    "many": _pairs([tuple(x) for x in np.random.default_rng(3).integers(
        0, R + 1, (200, 2))], seed=3),
    "empty": b"",
}


def _parse(parse, path, max_pairs, **kw):
    try:
        return parse(path, max_pairs, R, **kw)
    except ValueError as e:
        return str(e)


def _equal(got, want):
    if isinstance(want, str):
        assert got == want
        return
    assert len(got) == 4
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.flags.c_contiguous
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_parse_matches_sequential(tmp_path, case, threads):
    path = str(tmp_path / case)
    with open(path, "wb") as f:
        f.write(CASES[case])
    n = len(jnat.parse_pairs(path, 10 ** 4, R, threads=1)[2])
    for max_pairs in sorted({0, 1, max(n - 1, 0), n, n + 5}):
        _equal(_parse(tnat.parse_pairs, path, max_pairs, threads=threads),
               _parse(jnat.parse_pairs, path, max_pairs, threads=1))


def test_cases_split_where_they_say():
    kinds = {k: chr(CASES[k][len(CASES[k]) // 2])
             for k in CASES if k.startswith("split_")}
    assert kinds["split_in_line"] in "ACGT"
    assert kinds["split_on_newline"] == "\n"
    assert kinds["split_on_pattern_sentinel"] == ">"
    assert kinds["split_on_text_sentinel"] == "<"


def _offenders(tmp_path, bad):
    """200 pairs, those in ``bad`` a text or a pattern longer than R."""
    lens = [(R, R)] * 200
    for k, i in enumerate(bad):
        lens[i] = (R + 1, 2) if k % 2 else (3, R + 7)
    path = str(tmp_path / "bad")
    with open(path, "wb") as f:
        f.write(_pairs(lens, seed=7))
    return path


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("bad,max_pairs", [
    ((150, 31, 90), 200),   # offenders in several ranges: line 64
    ((150, 31, 90), 31),    # the first lies past max_pairs: no error
    ((150, 31, 90), 32),
    ((199,), 10 ** 6),
    ((0, 1), 200),
])
def test_first_offender_is_global(tmp_path, bad, max_pairs, threads):
    path = _offenders(tmp_path, bad)
    got = _parse(tnat.parse_pairs, path, max_pairs, threads=threads)
    want = _parse(jnat.parse_pairs, path, max_pairs, threads=1)
    _equal(got, want)
    first = min(bad)
    if first < max_pairs:
        assert got == (f"read longer than READ_SIZE={R} at line "
                       f"{2 * first + 2} of {path}")
    else:
        assert len(got[2]) == min(max_pairs, 200)


@pytest.mark.parametrize("max_pairs", [1, 2, 10])
def test_dangling_long_pattern_is_dropped(tmp_path, max_pairs):
    """A final pattern line longer than R without a text line: dropped,
    no error, also where it runs past the bytes max_pairs valid pairs
    take at most (the whole file is then read)."""
    path = str(tmp_path / "f")
    with open(path, "wb") as f:
        f.write(_pairs([(3, 4)]) + b">" + b"A" * (10 * R) + b"\n")
    for threads in THREADS:
        _equal(tnat.parse_pairs(path, max_pairs, R, threads=threads),
               jnat.parse_pairs(path, max_pairs, R, threads=1))


def test_sample_matches_sequential():
    for n in (0, 7, 1000, 2000, 10 ** 6):
        want = jnat.parse_pairs(SAMPLE, n, 112, threads=1)
        for threads in (0,) + THREADS:
            _equal(tnat.parse_pairs(SAMPLE, n, 112, threads=threads), want)


def test_missing_file(tmp_path):
    path = str(tmp_path / "missing")
    for threads in (0, 1, 7):
        with pytest.raises(FileNotFoundError, match="missing"):
            tnat.parse_pairs(path, 10, R, threads=threads)
    assert tnat.parse_threads(path, 10, R) == 1


def test_outputs_that_cannot_be_had(tmp_path, monkeypatch):
    path = str(tmp_path / "f")
    with open(path, "wb") as f:
        f.write(CASES["many"])

    def no_room(*a, **kw):
        raise MemoryError

    monkeypatch.setattr(tnat.np, "empty", no_room)
    with pytest.raises(MemoryError):
        tnat.parse_pairs(path, 100, R, threads=3)


def test_thread_rule(tmp_path, monkeypatch):
    monkeypatch.setattr(tnat.os, "cpu_count", lambda: 8)
    m = tnat.PARSE_MIN_BYTES
    path = str(tmp_path / "sparse")
    for size, want in ((0, 1), (m - 1, 1), (2 * m, 2), (3 * m + 5, 3),
                       (40 * m, 8)):
        with open(path, "wb") as f:
            f.truncate(size)
        assert tnat.parse_threads(path, 10 ** 9, 112) == want
    # the bytes max_pairs valid pairs take at most bound the rule
    assert tnat.parse_threads(path, 10, 112) == 1
    assert tnat.parse_threads(path, 3 * m // 228, 112) == 2
    monkeypatch.setattr(tnat.os, "cpu_count", lambda: 64)
    assert tnat.parse_threads(path, 10 ** 9, 112) == 16
    assert tnat.parse_threads(SAMPLE, 10 ** 6, 112) == 1


WFA = derive_config("wfa", 100, 0.01, backtrace=True, adaptive=True)


@pytest.mark.parametrize("min_bytes,want", [(None, 1), (4096, 8)])
def test_parse_threads_counter(tmp_path, monkeypatch, min_bytes, want):
    """1 below the size rule (the sample, about 200 KB), and the rule's
    threads above it."""
    monkeypatch.setattr(tnat.os, "cpu_count", lambda: 8)
    if min_bytes:
        monkeypatch.setattr(tnat, "PARSE_MIN_BYTES", min_bytes)
    res = tapi.align_file(SAMPLE, str(tmp_path / "o"), 200, WFA,
                          device="cpu", verbose=False)
    assert res.spans.counts["parse_threads"] == want
    assert res.spans.pairs == 200
