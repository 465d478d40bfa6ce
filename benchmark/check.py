"""The comparison that decides `correct`.

Every number compared is a count of pairs with a limit of 0:

- `failed`: pairs of window batches that raised or returned an error;
- `missing`: pairs whose place in an output holds no line with their
  index (dropped, reordered or duplicated pairs), over every pair;
- `score_diff`, `cigar_diff`: pairs of the sample whose score, or whose
  CIGAR as the writer prints it, differs from the plain reference's.
"""

from __future__ import annotations

import numpy as np

from reference import emit

LIMITS = {"failed": 0, "missing": 0, "score_diff": 0, "cigar_diff": 0}


def _line_starts(buf):
    nl = np.flatnonzero(buf == 10)
    starts = np.concatenate([[0], nl[:-1] + 1]).astype(np.int64)
    return starts, nl


def _indices(buf, starts, stops, width: int = 12):
    """The integer before the first comma of each line, -1 where the line
    does not start with one."""
    n = len(starts)
    cols = starts[:, None] + np.arange(width)[None, :]
    inside = cols < stops[:, None]
    win = np.where(inside, buf[np.minimum(cols, len(buf) - 1)], 0)
    comma = (win == ord(",")) & inside
    first = np.where(comma.any(1), np.argmax(comma, axis=1), -1)
    digit = (win >= ord("0")) & (win <= ord("9"))
    pos = np.arange(width)[None, :]
    before = pos < first[:, None]
    ok = (first > 0) & (digit | ~before).all(1)
    val = np.zeros(n, np.int64)
    for j in range(width):
        val = np.where(before[:, j], val * 10 + win[:, j] - ord("0"), val)
    return np.where(ok, val, -1)


def file_counts(path: str, n: int, sample, ref, backtrace: bool = True):
    """Counts of an output file of `n` pairs against the reference's
    (scores, ops, begin, end) of the pairs `sample`."""
    try:
        buf = np.fromfile(path, np.uint8)
    except OSError:
        return {"missing": n, "score_diff": 0, "cigar_diff": 0}
    per = 2 if backtrace else 1
    starts, stops = _line_starts(buf)
    heads = starts[0::per][:n]
    hstop = stops[0::per][:n]
    idx = _indices(buf, heads, hstop)
    present = int((idx == np.arange(len(idx))).sum())
    score_diff = cigar_diff = 0
    scores, ops, begin, end = ref
    for j, i in enumerate(np.asarray(sample).tolist()):
        if i >= len(heads):
            continue
        line = bytes(buf[heads[i]:hstop[i]])
        if line != emit.header(i, int(scores[j])):
            score_diff += 1
        if backtrace:
            k = per * i + 1
            got = bytes(buf[starts[k]:stops[k]]) if k < len(starts) else b""
            want = emit.cigar(emit.segment(ops[j], int(begin[j]),
                                           int(end[j])))
            cigar_diff += got != want
    return {"missing": n - present, "score_diff": score_diff,
            "cigar_diff": int(cigar_diff)}


def result_counts(res, ref, backtrace: bool = True):
    """Counts of one returned batch (scores, ops, begin, end) against the
    reference's for the same pairs."""
    scores, ops, begin, end = ref
    got_s = np.asarray(res[0])
    n = len(scores)
    if got_s.shape != (n,):
        return {"missing": n, "score_diff": 0, "cigar_diff": 0}
    score_diff = int((got_s != scores).sum())
    cigar_diff = 0
    if backtrace:
        go, gb, ge = res[1], res[2], res[3]
        have = min(n, *(len(a) if a is not None else 0 for a in (go, gb, ge)))
        cigar_diff = n - have
        for i in range(have):
            cigar_diff += (emit.segment(go[i], int(gb[i]), int(ge[i]))
                           != emit.segment(ops[i], int(begin[i]), int(end[i])))
    return {"missing": 0, "score_diff": score_diff, "cigar_diff": cigar_diff}


def total(parts, failed: int):
    out = {"failed": failed, "missing": 0, "score_diff": 0, "cigar_diff": 0}
    for p in parts:
        for k in ("missing", "score_diff", "cigar_diff"):
            out[k] += int(p[k])
    return out


def passed(counts) -> bool:
    return all(counts[k] <= LIMITS[k] for k in LIMITS)
