"""M1 and M2: primitive-cost probes, ported from the TPU probes of
``tools/microbench_mosaic.py`` (the twelve kernels ``_mk`` builds, :39,
bodies :69-249, and ``build_dynslice_row``, :252) to hand-written CUDA
(``csrc/probes.cu``).

Each probe repeats one body ``reps`` times with a carried dependency on a
fixed tile; its output is the Pallas probe's.  ``tools/microbench.py``
times it at two rep counts, and the slope is the cost of one rep of the
primitive on the card: the shuffles behind K2/K3/K6's lane shifts, the
shared-memory history rows of K1 and K4 (M2), ``__popc`` of K4/K7's
D-runs, int8 against int32 cells for K3.

Entry points:

  * ``PROBES``         the probes in order: name -> ``Probe`` (inputs,
                       plain version, int32 operations an element a rep).
  * ``run(name, reps, *inputs)``  the wrapper: CUDA tensors launch the
                       probe's kernel in ``csrc/probes.cu`` (or raise) and
                       count the launch in ``launch_counts``; CPU tensors
                       run the plain PyTorch version.
  * ``inputs(name, device)``  the probe's input tensors, as the reference
                       builds them.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Callable

import torch

I32 = torch.int32
M32 = (1 << 32) - 1


def _grid(rows, cols=128, device="cpu"):
    return torch.arange(rows * cols, dtype=I32, device=device).reshape(
        rows, cols)


# ---------------------------------------------------------------------------
# the plain versions (jnp's `%` is floor-mod, as torch's)
# ---------------------------------------------------------------------------

def gather_lanes(reps, src, idx):
    acc = torch.zeros_like(src)
    for _ in range(reps):
        g = torch.gather(src, 1, ((idx + acc) % 128).long())
        acc = (acc + g) % 7
    return acc


def gather_sublanes(reps, src, idx):
    acc = torch.zeros_like(src)
    for _ in range(reps):
        g = torch.gather(src, 0, ((idx + acc) % 56).long())
        acc = (acc + g) % 7
    return acc


def roll_sublane(reps, x):
    acc = x
    for _ in range(reps):
        acc = torch.roll(acc, 1, 0) + 1
    return acc


def roll_lane(reps, x):
    acc = x
    for _ in range(reps):
        acc = torch.roll(acc, 1, 1) + 1
    return acc


def _popcount32(v):
    """Set bits of the low 32 bits of an int64 tensor."""
    v = v & M32
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & M32) >> 24


def _to_i32(v):
    """The int32 whose bits are the low 32 bits of an int64 tensor."""
    v = v & M32
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(I32)


def popcount(reps, x):
    acc = x
    for _ in range(reps):
        acc = _popcount32((acc ^ x).long()).to(I32) + acc % 3
    return acc


def varshift(reps, x, s):
    r = s.long() & M32
    left = ((32 - s) % 32).long()
    acc = x
    for _ in range(reps):
        u = acc.long() & M32
        hi = torch.where(r < 32, u >> r.clamp(max=31), 0)
        lo = torch.where(left < 32, (u << left.clamp(max=31)) & M32, 0)
        acc = _to_i32(hi | lo)
    return acc


def i32_min(reps, x):
    acc = x
    for _ in range(reps):
        acc = torch.minimum(acc + 1, x) + (acc & 3)
    return acc


def i8_min(reps, x):
    return i32_min(reps, x)   # the same body: int8 tensors wrap as jnp's


def while_loop(reps, x):
    acc = x
    i = 0
    while i < reps and int(acc.max()) < 10 ** 6:
        acc = torch.minimum(acc + 1, acc * 2 + x % 5)
        i += 1
    return acc


def onehot_wordsel(reps, w, q):
    acc = torch.zeros_like(q)
    for _ in range(reps):
        acc = torch.gather(w, 0, ((q + acc) % 8).long()) % 9
    return acc


def transpose(reps, x):
    acc = x
    for _ in range(reps):
        acc = acc.t().contiguous() + 1
    return acc


def onehot_reduce(reps, nm, off):
    acc = torch.zeros_like(off)
    for _ in range(reps):
        e = torch.gather(nm, 1, ((off + acc) % 111).long())
        acc = (acc + e) % 5
    return acc


def dynslice_row(reps, x):
    hist = {0: x}   # the rows of the reference's [62, 56, 128] scratch
    acc = x
    for i in range(reps):
        s = i % 60
        r = hist[s] + 1
        hist[s + 1] = torch.minimum(r, acc)
        acc = r % 97
    return acc


# ---------------------------------------------------------------------------
# inputs, as tools/microbench_mosaic.py builds them
# ---------------------------------------------------------------------------

def _in_gather_lanes(dev):
    g = _grid(448, device=dev)
    return g % 101, (g * 7) % 128


def _in_gather_sublanes(dev):
    g = _grid(56, device=dev)
    return g % 101, (g * 7) % 56


def _in_tile56_101(dev):
    return (_grid(56, device=dev) % 101,)


def _in_tile56_30000(dev):
    return (_grid(56, device=dev) % 30000,)


def _in_varshift(dev):
    g = _grid(56, device=dev)
    return g % 30000, (g * 3) % 31 + 1


def _in_tile128(dev):
    return (_grid(128, device=dev) % 101,)


def _in_i8(dev):
    return ((_grid(128, device=dev) % 101).to(torch.int8),)


def _in_wordsel(dev):
    return _grid(8, device=dev) % 30000, (_grid(56, device=dev) * 3) % 8


def _in_onehot_reduce(dev):
    off = (torch.arange(128, dtype=I32, device=dev).reshape(128, 1) * 7) % 111
    return _grid(128, device=dev) % 101, off


@dataclass(frozen=True)
class Probe:
    """A probe: its index in csrc/probes.cu, the id of the TPU probe it
    ports (M1 or M2), that probe's name in the reference's PROBES and the
    line of its builder in tools/microbench_mosaic.py, its input builder
    and plain version, its output shape and type, and the int32 operations
    one element of its output takes a rep (the adds, mods, mins, logic,
    selects and gathers of the body)."""
    index: int
    tpu_id: str
    tpu_name: str
    tpu_line: int
    make_inputs: Callable
    plain: Callable
    out_shape: tuple
    ops_per_rep: int
    dtype: torch.dtype = I32


PROBES = {
    "gather_lanes": Probe(
        0, "M1", "gather_lanes", 69, _in_gather_lanes, gather_lanes,
        (448, 128), 5),
    "gather_sublanes": Probe(
        1, "M1", "gather_sublanes", 88, _in_gather_sublanes,
        gather_sublanes, (56, 128), 5),
    "roll_sublane": Probe(
        2, "M1", "roll_sublane", 106, _in_tile56_101, roll_sublane,
        (56, 128), 2),
    "roll_lane": Probe(
        3, "M1", "roll_lane", 117, _in_tile56_101, roll_lane, (56, 128), 2),
    "popcount": Probe(
        4, "M1", "popcount", 128, _in_tile56_30000, popcount, (56, 128), 4),
    "varshift": Probe(
        5, "M1", "varshift", 139, _in_varshift, varshift, (56, 128), 5),
    "i32_min_128x128": Probe(
        6, "M1", "i32_min_128x128", 155, _in_tile128, i32_min, (128, 128), 4),
    "i8_min_128x128": Probe(
        7, "M1", "i8_min_128x128", 168, _in_i8, i8_min, (128, 128), 4,
        torch.int8),
    "while_loop": Probe(
        8, "M1", "while_loop", 181, _in_tile56_101, while_loop, (56, 128), 6),
    "onehot_wordsel_56x128_W8": Probe(
        9, "M1", "onehot_wordsel_56x128_W8", 200, _in_wordsel,
        onehot_wordsel, (56, 128), 4),
    "transpose_128": Probe(
        10, "M1", "transpose_128", 221, _in_tile128, transpose, (128, 128),
        2),
    "onehot_reduce_rp": Probe(
        11, "M1", "onehot_reduce_Rp(today's extend/k)", 232,
        _in_onehot_reduce, onehot_reduce, (128, 1), 5),
    "dynslice_hist_row": Probe(
        12, "M2", "dynslice_hist_row", 252, _in_tile56_101, dynslice_row,
        (56, 128), 4),
}

# Launches of each probe's CUDA kernel since the last reset (CPU calls
# never count).
launch_counts = {name: 0 for name in PROBES}


def reset_launch_count():
    for name in launch_counts:
        launch_counts[name] = 0


def inputs(name: str, device="cpu"):
    return PROBES[name].make_inputs(torch.device(device))


@functools.lru_cache(maxsize=None)
def _signature(name: str):
    """((shape, dtype), ...) of the probe's inputs."""
    return tuple((tuple(t.shape), t.dtype)
                 for t in PROBES[name].make_inputs(torch.device("meta")))


def run(name: str, reps: int, *tensors):
    """The probe ``name`` over ``reps`` reps on ``tensors`` (as ``inputs``
    makes them).  CUDA tensors launch its kernel in csrc/probes.cu and
    raise if it fails; CPU tensors run the plain version."""
    pr = PROBES[name]
    want = _signature(name)
    if len(tensors) != len(want) or any(
            tuple(t.shape) != shape or t.dtype != dtype
            or not t.is_contiguous()
            for t, (shape, dtype) in zip(tensors, want)):
        raise ValueError(f"probe {name} takes {want} contiguous tensors")
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"probe {name}: tensors on several devices")
    if reps < 0:
        raise ValueError("reps must be >= 0")
    if dev.type == "cpu":
        return pr.plain(reps, *tensors)
    if dev.type != "cuda":
        raise ValueError(f"probe {name} runs on cuda or cpu, not {dev}")
    from aim_tpu_torch.ops import _build
    lib = _build.load()
    out = torch.empty(pr.out_shape, dtype=pr.dtype, device=dev)
    b = tensors[1].data_ptr() if len(tensors) > 1 else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.aim_probe(pr.index, tensors[0].data_ptr(), b,
                           out.data_ptr(), reps, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"probe {name} launch failed: "
                           f"{_build.error_string(rc)} (cudaError {rc})")
    launch_counts[name] += 1
    return out


def elements(name: str) -> int:
    """Output elements of a probe (its work items for the bound)."""
    n = 1
    for d in PROBES[name].out_shape:
        n *= d
    return n
