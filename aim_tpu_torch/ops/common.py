"""Shared helpers: padding arithmetic, 2-bit packing, upload, the checks
every kernel wrapper makes on its pair tensors, and the lane primitives of
the dense exact tiers (``ops/nw_xla.py``, ``swg_xla.py``).

``round_up``, ``pack_seqs``, ``min_plus_scan``, ``shift_right_lanes`` and
``gather_lane`` are copies of ``aim_tpu.ops.band.round_up`` and
``aim_tpu.ops.common`` (that package imports jax at module level, so the
port carries its own copies; tests hold them equal).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from aim_tpu_torch import spans

# The reference scan's fill for masked lanes (aim_tpu/ops/common.py:28).
SCAN_BIG = 2 ** 24
# input bytes (both arrays' rows) a thread of the pack pass takes at
# least: below twice this the pass runs on the calling thread.  On an
# H100's 8-core host a std::thread costs ~0.15 ms to start; a pass of
# 2 MiB ran no faster on 2 threads than on one, 4 MiB ran fastest on 4.
PACK_MIN_BYTES = 1 << 20


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def min_plus_scan(z: torch.Tensor, slope: int) -> torch.Tensor:
    """Min-plus prefix scan along the last axis,

        out[v] = min_{j <= v} ( z[j] + (v - j) * slope ),

    the closed form of the reference's deletion chain
    ``cell[v] = min(indep[v], cell[v-1] + gap)``.  The reference runs it
    as log2(width) masked shift+min steps whose masked lanes take 2**24;
    that fill reaches every lane through lane 0's prefix, so its result is
    ``min(cummin(z - ramp), 2**24) + ramp`` whenever the width is above
    one, which this computes with one ``cummin``.  Integers: exact."""
    w = z.shape[-1]
    ramp = torch.arange(w, dtype=z.dtype, device=z.device) * slope
    x = z - ramp
    if w > 1:
        x = torch.cummin(x, dim=-1).values.clamp_(max=SCAN_BIG)
    return x + ramp


def shift_right_lanes(x: torch.Tensor, fill) -> torch.Tensor:
    """out[..., v] = x[..., v-1]; out[..., 0] = fill."""
    out = torch.empty_like(x)
    out[..., 1:] = x[..., :-1]
    out[..., 0] = fill
    return out


def gather_lane(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-row lane gather of a 2-D x: out[n] = x[n, idx[n]], and 0 where
    idx[n] lies outside the row (the reference's one-hot sum)."""
    w = x.shape[1]
    inside = (idx >= 0) & (idx < w)
    g = x.gather(1, idx.clamp(0, w - 1).long()[:, None])[:, 0]
    return torch.where(inside, g, torch.zeros_like(g))


def pack_seqs(pats, txts, plens, tlens, read_size: int):
    """Host-side 2-bit packing of a [n, R] uint8 sequence pair batch.

    Returns (packed_pats, packed_txts [n, Rp//4] u8, True) when the
    COMBINED alphabet has <= 4 symbols (the DNA case), else the inputs
    unchanged with False.  One shared injective recode preserves alignment
    semantics: the kernels only compare pattern bytes against text bytes
    for equality.  The native pass runs on ``_pack_threads`` threads and
    adds the threads of its fused ACGT pass to the call's ``pack_threads``.
    """
    Rp = -(-(read_size + 2) // 8) * 8
    from aim_tpu_torch import native
    if native.available():
        pats = np.ascontiguousarray(pats, np.uint8)
        pp, pt, ok, threads = native.pack_seqs(
            pats, np.ascontiguousarray(txts, np.uint8), plens, tlens, Rp,
            _pack_threads(*pats.shape))
        spans.count("pack_threads", threads)
        return pp, pt, ok
    seen = np.zeros(256, bool)
    seen[pats.reshape(-1)] = True
    seen[txts.reshape(-1)] = True
    syms = np.nonzero(seen)[0]
    if seen[0]:
        syms = syms[1:]  # byte 0 beyond the valid region is just padding
    if len(syms) > 4:
        return pats, txts, False
    if seen[0]:
        # Byte 0 may alias syms[0]'s code only if it never occurs INSIDE a
        # valid region (positions < plen/tlen).
        pos = np.arange(pats.shape[1])
        if ((pats == 0) & (pos < np.asarray(plens)[:, None])).any() or \
           ((txts == 0) & (pos < np.asarray(tlens)[:, None])).any():
            return pats, txts, False
    lut = np.zeros(256, np.uint8)
    lut[syms] = np.arange(len(syms), dtype=np.uint8)

    def one(arr):
        codes = np.zeros((arr.shape[0], Rp), np.uint8)
        codes[:, :arr.shape[1]] = lut[arr]
        pk = (codes[:, 0::4] | (codes[:, 1::4] << 2)
              | (codes[:, 2::4] << 4) | (codes[:, 3::4] << 6))
        return np.ascontiguousarray(pk)

    return one(pats), one(txts), True


def _pack_threads(n: int, width: int) -> int:
    """Threads for the pack pass over ``n`` pairs of ``width``-byte rows:
    one for each ``PACK_MIN_BYTES`` of both arrays, at least one, at most
    parse's min(cores, 16)."""
    cores = min(os.cpu_count() or 1, 16)
    return max(1, min(cores, 2 * n * width // PACK_MIN_BYTES))


def to_device_batch(pats, txts, plens, tlens, device):
    """Numpy pair batch -> (pats u8, txts u8, plens i32, tlens i32) tensors
    on ``device``.  CUDA uploads go through pinned host buffers, copied
    asynchronously on the current stream (the caller synchronises)."""
    device = torch.device(device)
    arrs = (np.ascontiguousarray(pats, np.uint8),
            np.ascontiguousarray(txts, np.uint8),
            np.ascontiguousarray(plens, np.int32),
            np.ascontiguousarray(tlens, np.int32))
    if device.type != "cuda":
        return tuple(torch.from_numpy(a).to(device) for a in arrs)
    return tuple(torch.from_numpy(a).pin_memory().to(device,
                                                      non_blocking=True)
                 for a in arrs)


def check_pair_tensors(pats, txts, plens, tlens, who: str):
    """Raise unless pats/txts are 2-D uint8 of one nonzero width and
    plens/tlens 1-D int32, all contiguous, with one row count, on one CPU
    or CUDA device: what every kernel wrapper accepts."""
    for name, t, dt, nd in (("pats", pats, torch.uint8, 2),
                            ("txts", txts, torch.uint8, 2),
                            ("plens", plens, torch.int32, 1),
                            ("tlens", tlens, torch.int32, 1)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{who}: {name} must be a torch.Tensor")
        if t.dtype != dt or t.dim() != nd:
            raise TypeError(f"{who}: {name} must be a {nd}-D {dt} tensor, "
                            f"got {t.dim()}-D {t.dtype}")
        if t.device != pats.device:
            raise ValueError(f"{who}: {name} is on {t.device}, pats on "
                             f"{pats.device}")
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")
        if t.shape[0] != pats.shape[0]:
            raise ValueError(f"{who}: {name} has {t.shape[0]} rows, pats "
                             f"{pats.shape[0]}")
    if txts.shape[1] != pats.shape[1] or pats.shape[1] == 0:
        raise ValueError(f"{who}: pats {tuple(pats.shape)} and txts "
                         f"{tuple(txts.shape)} need one nonzero width")
    if pats.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{who} runs on cuda or cpu, not {pats.device}")
