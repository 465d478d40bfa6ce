"""Backend dispatch: the port's counterpart of
``aim_tpu/ops/pallas_kernels.py::forward_fn``.

``forward_fn(cfg, packed_ok)`` returns the kernel tier that serves a config
the port has ported, admitted exactly as the reference admits it, with
its band-retry ladder, and raises ``NotImplementedError`` naming the
ROADMAP item for every other config.  It never hands a config to the host
oracle.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable

from aim_tpu_torch.config import ALGO_GENASM, ALGO_NW, ALGO_SWG, ALGO_WFA, \
    AlignConfig
from aim_tpu_torch.ops import (genasm, genasm_long, nw, nwswg_long, swg, wfa2,
                               wfa_long)
from aim_tpu_torch.ops.genasm_long import long_fit_genasm
from aim_tpu_torch.ops.nwswg_long import long_fit_nwswg

# record grammars (the reference's output keys)
STEP_RECORDS = "step_records"   # [n, smax+4] int32, native.wfa_steps_to_ops
PACKED_RUNS = "packed_runs"     # [n, NRL] int16, native.wfa_runs_to_ops
# [n, R+4] int32: the step-record grammar with one level row a text
# position, native.wfa_steps_to_ops(max_score=read_size)
GENASM_RECORDS = "genasm_records"

_XLA = ("the exact fallback tier is not ported yet (ROADMAP Queue 1 item 5)")


@dataclass(frozen=True)
class Tier:
    """A kernel tier: its wrapper, the record grammar it emits, the device
    memory one pair holds during a call, and the band-retry ladder: the
    wide-band wrapper flagged pairs re-run on (``retry(*tensors, cfg=,
    planes=)``, None without one), the device memory one pair holds there
    (``retry_bytes_per_pair(planes)``) and the plane count of the primary
    band, below which no ladder stage runs."""
    forward: Callable
    records: str
    device_bytes_per_pair: int
    retry: Callable | None = None
    retry_bytes_per_pair: Callable[[int], int] | None = None
    primary_planes: int = 1

    def __call__(self, *args, **kw):
        return self.forward(*args, **kw)


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
                primary_planes=p0, **_wide_retry(cfg))


def forward_fn(cfg: AlignConfig, packed_ok: bool = True) -> Tier:
    """The kernel tier that serves ``cfg``, routed as
    ``aim_tpu/ops/pallas_kernels.py::forward_fn`` routes it:

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
    The tier takes (pats, txts, plens, tlens, *, cfg, packed) tensors on
    one device.  Every other config raises ``NotImplementedError`` naming
    the ROADMAP item of the exact fallback tier."""
    if cfg.algo == ALGO_WFA:
        if wfa2.vmem_fit2(cfg):
            return Tier(wfa2.wfa_forward2, STEP_RECORDS,
                        wfa2.device_bytes_per_pair(cfg))
        if wfa_long.long_fit(cfg, bytes_mode=not packed_ok):
            return Tier(wfa_long.wfa_forward_long, STEP_RECORDS,
                        wfa_long.device_bytes_per_pair(cfg))
        raise NotImplementedError(
            f"WFA read_size={cfg.read_size} max_score={cfg.max_score} "
            f"packed={packed_ok} is outside the short- and long-read tiers: "
            + _XLA)
    if cfg.algo == ALGO_NW and nw.vmem_fit_nw(cfg):
        return Tier(nw.nw_forward, PACKED_RUNS, nw.device_bytes_per_pair(cfg),
                    **_wide_retry(cfg))
    if cfg.algo == ALGO_SWG and swg.admitted(cfg):
        return Tier(swg.swg_forward, PACKED_RUNS,
                    swg.device_bytes_per_pair(cfg), **_wide_retry(cfg))
    if cfg.algo in (ALGO_NW, ALGO_SWG):
        if long_fit_nwswg(cfg):
            return _streamed(cfg)
        raise NotImplementedError(
            f"{cfg.algo} read_size={cfg.read_size} "
            f"max_score={cfg.max_score} match={cfg.match} "
            f"variant={cfg.variant} is outside the short-read and streamed "
            "tiers: " + _XLA)
    if cfg.algo == ALGO_GENASM:
        if packed_ok and genasm.vmem_fit_genasm(cfg):
            return Tier(genasm.genasm_forward, GENASM_RECORDS,
                        genasm.device_bytes_per_pair(cfg))
        if long_fit_genasm(cfg):
            return Tier(genasm_long.genasm_forward_long, PACKED_RUNS,
                        genasm_long.bytes_per_pair(cfg),
                        retry=genasm_long.genasm_forward_long,
                        retry_bytes_per_pair=functools.partial(
                            genasm_long.bytes_per_pair, cfg),
                        primary_planes=genasm_long._npl(cfg))
        raise NotImplementedError(
            f"genasm read_size={cfg.read_size} max_score={cfg.max_score} "
            f"packed={packed_ok} is outside the short-read and long tiers: "
            "the exact host tier is not ported yet (ROADMAP Queue 1 item 5)")
    raise NotImplementedError(f"{cfg.algo}: unknown algorithm")
