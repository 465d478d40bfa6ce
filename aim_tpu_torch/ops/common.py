"""Shared host-side helpers: padding arithmetic, 2-bit packing, upload,
and the checks every kernel wrapper makes on its pair tensors.

``round_up`` and ``pack_seqs`` are copies of ``aim_tpu.ops.band.round_up``
and ``aim_tpu.ops.common.pack_seqs`` (that package imports jax at module
level, so the port carries its own copies; tests hold them equal).
"""

from __future__ import annotations

import numpy as np
import torch


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pack_seqs(pats, txts, plens, tlens, read_size: int):
    """Host-side 2-bit packing of a [n, R] uint8 sequence pair batch.

    Returns (packed_pats, packed_txts [n, Rp//4] u8, True) when the
    COMBINED alphabet has <= 4 symbols (the DNA case), else the inputs
    unchanged with False.  One shared injective recode preserves alignment
    semantics: the kernels only compare pattern bytes against text bytes
    for equality.
    """
    Rp = -(-(read_size + 2) // 8) * 8
    try:
        from aim_tpu import native
        if native.available():
            return native.pack_seqs(np.ascontiguousarray(pats, np.uint8),
                                    np.ascontiguousarray(txts, np.uint8),
                                    plens, tlens, Rp)
    except Exception:
        pass  # fall through to the numpy path
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
