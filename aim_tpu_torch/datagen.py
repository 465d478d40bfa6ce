"""Synthetic pair-file generator — the in-repo data layer.

The port's own copy of ``aim_tpu/datagen.py`` (byte-equal output for a
seed; tests hold the two equal).

The reference ships two sample pair files and points at the WFA
repository's `generate_dataset` tool for the synthetic long-read sets
(ref: Datasets/README.md:3-26).  This module mirrors that generator's
semantics so the repo is self-contained: a random pattern of length
`length` over ACGT, and a text derived from it by `ceil(length*error)`
edits, each at a uniform-random position with type drawn uniformly from
{mismatch, insertion, deletion} (a mismatch substitutes a different
base, so every edit is a real edit).

Two surfaces:
  * `generate_pairs`   — packed arrays, ready for `aim_tpu_torch.api.align`
                         (same return contract as native.parse_pairs);
  * `write_pair_file`  — the on-disk `>pattern\\n<text\\n` grammar the
                         reference consumes (ref: host.c:91-134), used
                         by the `gen` CLI subcommand.
"""

from __future__ import annotations

import math

import numpy as np

_BASES = np.frombuffer(b"ACGT", np.uint8)


def _mutate(pat: np.ndarray, n_err: int, rng) -> np.ndarray:
    """Apply n_err uniform-position, uniform-type edits to a copy of pat."""
    text = list(pat)
    for _ in range(n_err):
        kind = rng.integers(0, 3)
        if kind == 2 and len(text) > 1:        # deletion
            pos = int(rng.integers(0, len(text)))
            del text[pos]
        elif kind == 1:                        # insertion
            pos = int(rng.integers(0, len(text) + 1))
            text.insert(pos, int(_BASES[rng.integers(0, 4)]))
        else:                                  # mismatch (different base)
            pos = int(rng.integers(0, len(text)))
            cur = text[pos]
            repl = int(_BASES[rng.integers(0, 4)])
            while repl == cur:
                repl = int(_BASES[rng.integers(0, 4)])
            text[pos] = repl
    return np.asarray(text, np.uint8)


def generate_texts(n_pairs: int, length: int, error: float, seed: int = 0):
    """Yield (pattern, text) uint8 arrays, variable text lengths."""
    rng = np.random.default_rng(seed)
    n_err = math.ceil(length * error)
    for _ in range(n_pairs):
        pat = _BASES[rng.integers(0, 4, length)]
        yield pat, _mutate(pat, n_err, rng)


def generate_pairs(n_pairs: int, length: int, error: float,
                   read_size: int | None = None, seed: int = 0):
    """Packed-array form: (patterns [n,R] u8, texts [n,R] u8,
    plens [n] i32, tlens [n] i32) — the parse_pairs return contract."""
    if read_size is None:
        # Launcher padding rule: roundup8(l + ceil(e*l))
        # (ref: run-wfa-pim-mram.py:58-67).
        read_size = -8 * (-(length + math.ceil(length * error)) // 8)
    pats = np.zeros((n_pairs, read_size), np.uint8)
    txts = np.zeros((n_pairs, read_size), np.uint8)
    plens = np.zeros(n_pairs, np.int32)
    tlens = np.zeros(n_pairs, np.int32)
    for i, (pat, text) in enumerate(
            generate_texts(n_pairs, length, error, seed)):
        if len(pat) > read_size or len(text) > read_size:
            raise ValueError(
                f"generated sequence exceeds read_size={read_size}; "
                f"raise read_size (launcher rule: roundup8(l+ceil(e*l)))")
        pats[i, :len(pat)] = pat
        txts[i, :len(text)] = text
        plens[i] = len(pat)
        tlens[i] = len(text)
    return pats, txts, plens, tlens


def write_pair_file(path: str, n_pairs: int, length: int, error: float,
                    seed: int = 0) -> int:
    """Write the reference's pair-file grammar: '>pattern\\n<text\\n' per
    pair (ref: Datasets/sample-l100-e1-40K; host.c get_reads strips the
    sentinel char).  Returns the number of pairs written."""
    with open(path, "wb") as f:
        for pat, text in generate_texts(n_pairs, length, error, seed):
            f.write(b">" + pat.tobytes() + b"\n")
            f.write(b"<" + text.tobytes() + b"\n")
    return n_pairs
