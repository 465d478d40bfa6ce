"""Seeded read-pair generator, vectorised over pairs.

The semantics of the WFA repository's `generate_dataset`, which the AIM
reference's Datasets/README.md points at for its synthetic sets: a
uniform random pattern of `length` bases over ACGT, and a text made from
it by `ceil(length * error)` edits, each at a uniform position, its type
uniform over mismatch (a different base), insertion (a random base) and
deletion.  Here the edits of a pair sit at distinct pattern positions and
are applied in one pass (an insertion goes before its position), so no
edit lands on a base an earlier one made.

Rows come back in the pair parser's contract: ASCII bases in `[n, R]`
uint8 arrays padded with 0, and int32 lengths.  `write_pairs` writes the
reference's `>pattern\\n<text\\n` grammar.
"""

from __future__ import annotations

import math
from concurrent.futures import ThreadPoolExecutor

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)
MISMATCH, INSERTION, DELETION = 0, 1, 2
_BLOCK_ELEMS = 1 << 22          # pattern bases handled at once


def rng(seed: int, *stream: int) -> np.random.Generator:
    """The generator of one stream of a run's seed (any whole number)."""
    return np.random.default_rng([seed % (1 << 64), *stream])


def read_size(length: int, error: float) -> int:
    """The launchers' padding rule, roundup8(l + ceil(l * e))."""
    return -8 * (-(length + math.ceil(length * error)) // 8)


def _block(b, length, n_err, size, gen):
    """`b` pairs: (pats, txts, tlens, positions, kinds)."""
    codes = gen.integers(0, 4, (b, length), dtype=np.uint8)
    if n_err == 1:
        pos = gen.integers(0, length, (b, 1))
    elif n_err:
        pos = np.argpartition(gen.random((b, length), np.float32),
                              n_err - 1, axis=1)[:, :n_err]
    else:
        pos = np.zeros((b, 0), np.int64)
    kinds = gen.integers(0, 3, (b, n_err), dtype=np.int8)
    shift = gen.integers(1, 4, (b, n_err), dtype=np.uint8)
    ins_code = gen.integers(0, 4, (b, n_err), dtype=np.uint8)
    # the edits in pattern order, each with the text position it lands
    # on: its position, plus the insertions before it, less the deletions
    # before it
    order = np.argsort(pos, axis=1)
    pos = np.take_along_axis(pos, order, 1)
    kinds = np.take_along_axis(kinds, order, 1)
    shift = np.take_along_axis(shift, order, 1)
    ins_code = np.take_along_axis(ins_code, order, 1)
    ins = kinds == INSERTION
    dele = kinds == DELETION
    at = (pos + np.cumsum(ins, 1) - ins - np.cumsum(dele, 1) + dele
          ).astype(np.int64)
    tl = length + ins.sum(1) - dele.sum(1)
    if tl.max(initial=0) > size:
        raise ValueError(f"text longer than read_size={size}")
    # text column j copies pattern column j + (deletions landing at or
    # before j) - (insertions before j); the edited columns are written
    # after
    rows = np.broadcast_to(np.arange(b)[:, None], pos.shape)
    delta = np.zeros((b, size + 1), np.int32)
    np.add.at(delta, (rows[dele], at[dele]), 1)
    np.add.at(delta, (rows[ins], at[ins] + 1), -1)
    src = np.arange(size)[None, :] + np.cumsum(delta[:, :size], 1)
    txt = np.take_along_axis(codes, np.clip(src, 0, length - 1), 1)
    mis = kinds == MISMATCH
    txt[rows[mis], at[mis]] = (codes[rows[mis], pos[mis]] + shift[mis]) % 4
    txt[rows[ins], at[ins]] = ins_code[ins]
    txt = np.where(np.arange(size)[None, :] < tl[:, None], BASES[txt], 0)
    pat = np.zeros((b, size), np.uint8)
    pat[:, :length] = BASES[codes]
    return pat, txt.astype(np.uint8), tl, pos, kinds


def _blocks(n, width):
    step = max(1, _BLOCK_ELEMS // max(width, 1))
    return [(lo, min(n, lo + step)) for lo in range(0, n, step)]


def generate(n: int, length: int, error: float, seed: int, stream: int = 0,
             size: int | None = None, with_edits: bool = False,
             workers: int = 8):
    """`n` pairs of stream `stream` of `seed` as (pats, txts, plens,
    tlens), plus (positions, kinds) `[n, E]` of the edits when
    `with_edits`.  Blocks of pairs draw from streams of their own and are
    made on `workers` threads; the pairs depend on the seed alone."""
    size = size or read_size(length, error)
    n_err = math.ceil(length * error)
    pats = np.zeros((n, size), np.uint8)
    txts = np.zeros((n, size), np.uint8)
    tlens = np.zeros(n, np.int32)
    pos_all = np.zeros((n, n_err), np.int32)
    kind_all = np.zeros((n, n_err), np.int8)

    def one(k, lo, hi):
        out = _block(hi - lo, length, n_err, size, rng(seed, stream, k))
        pats[lo:hi], txts[lo:hi], tlens[lo:hi] = out[:3]
        pos_all[lo:hi], kind_all[lo:hi] = out[3:]

    with ThreadPoolExecutor(max_workers=workers) as ex:
        for f in [ex.submit(one, k, lo, hi)
                  for k, (lo, hi) in enumerate(_blocks(n, length))]:
            f.result()
    plens = np.full(n, length, np.int32)
    if with_edits:
        return pats, txts, plens, tlens, (pos_all, kind_all)
    return pats, txts, plens, tlens


def _lines(pats, txts, plens, tlens):
    """The file bytes of these pairs."""
    b, size = pats.shape
    buf = np.zeros((b, 2 * size + 4), np.uint8)
    r = np.arange(b)
    buf[:, 0] = ord(">")
    buf[:, 1:size + 1] = pats
    buf[r, 1 + plens] = ord("\n")
    buf[:, size + 2] = ord("<")
    buf[:, size + 3:2 * size + 3] = txts
    buf[r, size + 3 + tlens] = ord("\n")
    col = np.arange(2 * size + 4)[None, :]
    keep = (col <= 1 + plens[:, None]) | (
        (col >= size + 2) & (col <= size + 3 + tlens[:, None]))
    return buf[keep]


def write_pairs(path: str, pats, txts, plens, tlens,
                workers: int = 8) -> int:
    """Write pairs as `>pattern\\n<text\\n` lines; returns bytes written."""
    n, size = pats.shape
    total = 0
    with open(path, "wb") as f, ThreadPoolExecutor(max_workers=workers) as ex:
        parts = [ex.submit(_lines, pats[lo:hi], txts[lo:hi], plens[lo:hi],
                           tlens[lo:hi]) for lo, hi in _blocks(n, size)]
        for part in parts:
            chunk = part.result()
            f.write(chunk.tobytes())
            total += chunk.size
    return total
