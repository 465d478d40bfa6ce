"""The AIM reference's output file, in plain Python: for each pair the
line `<idx>, <score>, ` and, with backtrace, the run-length CIGAR of its
ops (`72M1X27M`), as safaad/aim's host writes them."""

from __future__ import annotations

import re

_RUN = re.compile(rb"(.)\1*", re.S)


def segment(ops_row, begin: int, end: int) -> bytes:
    """The ops the writer reads for a pair: at least the op at `begin`."""
    return bytes(ops_row[begin:max(end, begin + 1)])


def cigar(seg: bytes) -> bytes:
    return b"".join(b"%d%c" % (len(m.group(0)), m.group(0)[0])
                    for m in _RUN.finditer(seg))


def header(idx: int, score: int) -> bytes:
    return b"%d, %d, " % (idx, score)


def write(path: str, scores, ops, begin, end, backtrace: bool = True):
    with open(path, "wb") as f:
        for i, s in enumerate(scores.tolist()):
            f.write(header(i, s) + b"\n")
            if backtrace:
                f.write(cigar(segment(ops[i], int(begin[i]), int(end[i])))
                        + b"\n")
