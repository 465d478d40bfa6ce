"""Backend dispatch: the port's counterpart of
``aim_tpu/ops/pallas_kernels.py::forward_fn`` and of the XLA / host
branches of ``aim_tpu/api.py::_forward_fn``.

``forward_fn(cfg, packed_ok)`` returns the tier that serves a config: the
kernel tier the reference admits it to, with its band-retry ladder, or,
exactly where the reference's Pallas dispatch returns none (and for every
config under ``backend="xla"``), the dense exact tier (NW, SWG, WFA in
plain PyTorch on the device) or, for GenASM, the host tier (the exact
native oracle is the compute path).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

from aim_tpu_torch.config import ALGO_GENASM, ALGO_NW, ALGO_SWG, ALGO_WFA, \
    AlignConfig
from aim_tpu_torch.ops import (genasm, genasm_long, nw, nw_xla, nwswg_long,
                               swg, swg_xla, wfa2, wfa_long, wfa_xla)
from aim_tpu_torch.ops.genasm_long import long_fit_genasm
from aim_tpu_torch.ops.nwswg_long import long_fit_nwswg

# record grammars (the reference's output keys)
STEP_RECORDS = "step_records"   # [n, smax+4] int32, native.wfa_steps_to_ops
PACKED_RUNS = "packed_runs"     # [n, NRL] int16, native.wfa_runs_to_ops
# [n, R+4] int32: the step-record grammar with one level row a text
# position, native.wfa_steps_to_ops(max_score=read_size)
GENASM_RECORDS = "genasm_records"
# the dense tiers' outputs, a dict of tensors each: ``scores`` [n] int32,
# ``needs_fallback`` [n] bool and with backtrace ``bits`` u8 direction codes
# (NW [n, R+1, ceil((R+1)/4)], native.nw_traceback_bits; SWG
# [n, R+1, ceil((R+1)/2)], native.swg_traceback_bits); WFA ``scores`` and
# with backtrace ``packed_hist`` [n, S+1, 3K] and ``packed_meta``
# [n, S+1, 3] int16, native.wfa_backtrace_batch
DENSE_NW = "dense_nw"
DENSE_SWG = "dense_swg"
DENSE_WFA = "dense_wfa"
DENSE_RECORDS = (DENSE_NW, DENSE_SWG, DENSE_WFA)
# no device work: the exact native oracle computes every pair
HOST = "host"


@dataclass(frozen=True)
class Tier:
    """A tier: its wrapper (None for the host tier), the record grammar it
    emits, the device memory one pair holds during a call, and the
    band-retry ladder: the wide-band wrapper flagged pairs re-run on
    (``retry(*tensors, cfg=, planes=)``, None without one), the device
    memory one pair holds there (``retry_bytes_per_pair(planes)``) and the
    plane count of the primary band, below which no ladder stage runs.
    ``name`` is the kernel's id (K1..K6) or "dense" / "host"."""
    forward: Callable | None
    records: str
    device_bytes_per_pair: int
    retry: Callable | None = None
    retry_bytes_per_pair: Callable[[int], int] | None = None
    primary_planes: int = 1
    name: str = ""

    def __call__(self, *args, **kw):
        return self.forward(*args, **kw)


def exact_tier(cfg: AlignConfig) -> Tier:
    """The exact tier of ``cfg``: the dense tier of NW, SWG and WFA (JAX's
    XLA tier), or GenASM's host tier (aim_tpu/api.py:146-157, 572-581).
    None of them retries: flagged dense pairs go to the oracle."""
    if cfg.algo == ALGO_GENASM:
        return Tier(None, HOST, 1, name="host")
    mod, fwd, records = {
        ALGO_NW: (nw_xla, nw_xla.nw_forward, DENSE_NW),
        ALGO_SWG: (swg_xla, swg_xla.swg_forward, DENSE_SWG),
        ALGO_WFA: (wfa_xla, wfa_xla.wfa_forward, DENSE_WFA)}[cfg.algo]
    return Tier(fwd, records, mod.device_bytes_per_pair(cfg), name="dense")


def _wide_retry(cfg: AlignConfig) -> dict:
    """The streamed tier as the wide-band retry of an NW/SWG tier, where
    it admits the config (pallas_kernels.py::_attach_wide_retry): the
    ``Tier`` fields of the ladder, or none."""
    if not long_fit_nwswg(cfg):
        return {}
    return dict(retry=nwswg_long.nwswg_forward_long,
                retry_bytes_per_pair=functools.partial(
                    nwswg_long.device_bytes_per_pair, cfg))


def _streamed(cfg: AlignConfig) -> Tier:
    """The streamed NW/SWG tier (K6/K7) at the routed primary plane count
    (pallas_kernels.py::long_fit_nwswg_routed)."""
    p0 = nwswg_long.route_planes(cfg)
    return Tier(functools.partial(nwswg_long.nwswg_forward_long, planes=p0),
                PACKED_RUNS, nwswg_long.device_bytes_per_pair(cfg, p0),
                primary_planes=p0, name="K6", **_wide_retry(cfg))


def forward_fn(cfg: AlignConfig, packed_ok: bool = True) -> Tier:
    """The tier that serves ``cfg``.  Under ``backend="xla"`` that is the
    exact tier (``exact_tier``); under "auto" and "pallas" the kernel tier,
    routed as ``aim_tpu/ops/pallas_kernels.py::forward_fn`` routes it:

      * WFA: the short-read tier (K1) when ``vmem_fit2`` admits it, else
        the long-read tier (K5) when ``long_fit`` does in the batch's word
        layout (2-bit packed, or raw bytes when ``packed_ok`` is False);
      * NW: the short-read tier (K2) when ``vmem_fit_nw`` does (whatever
        the variant, as in JAX), else the streamed tier (K6/K7) at
        ``route_planes(cfg)`` planes; SWG: the short-read tier (K3) under
        ``swg.admitted``, else the streamed tier when ``long_fit_nwswg``
        admits it.  K2 and K3 retry flagged pairs on the streamed tier's
        wider bands wherever it admits the config;
      * GenASM: the short-read tier (K4) when ``vmem_fit_genasm`` admits
        it and the batch packs, else the long tier (unit-cost K6/K7, any
        byte alphabet) when ``long_fit_genasm`` does.

    ``packed_ok`` is False for a batch whose alphabet cannot 2-bit pack.
    Where none of them admits the config, it is the exact tier, as JAX
    falls back to its XLA or host tier.  Every tier takes (pats, txts,
    plens, tlens, *, cfg, packed) tensors on one device; the dense tiers
    take raw bytes."""
    if cfg.backend == "xla":
        return exact_tier(cfg)
    if cfg.algo == ALGO_WFA:
        if wfa2.vmem_fit2(cfg):
            return Tier(wfa2.wfa_forward2, STEP_RECORDS,
                        wfa2.device_bytes_per_pair(cfg), name="K1")
        if wfa_long.long_fit(cfg, bytes_mode=not packed_ok):
            return Tier(wfa_long.wfa_forward_long, STEP_RECORDS,
                        wfa_long.device_bytes_per_pair(cfg), name="K5")
    if cfg.algo == ALGO_NW and nw.vmem_fit_nw(cfg):
        return Tier(nw.nw_forward, PACKED_RUNS, nw.device_bytes_per_pair(cfg),
                    name="K2", **_wide_retry(cfg))
    if cfg.algo == ALGO_SWG and swg.admitted(cfg):
        return Tier(swg.swg_forward, PACKED_RUNS,
                    swg.device_bytes_per_pair(cfg), name="K3",
                    **_wide_retry(cfg))
    if cfg.algo in (ALGO_NW, ALGO_SWG) and long_fit_nwswg(cfg):
        return _streamed(cfg)
    if cfg.algo == ALGO_GENASM:
        if packed_ok and genasm.vmem_fit_genasm(cfg):
            return Tier(genasm.genasm_forward, GENASM_RECORDS,
                        genasm.device_bytes_per_pair(cfg), name="K4")
        if long_fit_genasm(cfg):
            return Tier(genasm_long.genasm_forward_long, PACKED_RUNS,
                        genasm_long.bytes_per_pair(cfg),
                        retry=genasm_long.genasm_forward_long,
                        retry_bytes_per_pair=functools.partial(
                            genasm_long.bytes_per_pair, cfg),
                        primary_planes=genasm_long._npl(cfg), name="K6")
    return exact_tier(cfg)
