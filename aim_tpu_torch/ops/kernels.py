"""Backend dispatch: the port's counterpart of
``aim_tpu/ops/pallas_kernels.py::forward_fn``.

``forward_fn(cfg, packed_ok)`` returns the kernel tier that serves a config
the port has ported, admitted exactly as the reference admits it, and
raises ``NotImplementedError`` naming the ROADMAP item for every other
config.  It never hands a config to the host oracle.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from aim_tpu.config import ALGO_GENASM, ALGO_NW, ALGO_SWG, ALGO_WFA, \
    AlignConfig
from aim_tpu_torch.ops import genasm, nw, swg, wfa2, wfa_long

# record grammars (the reference's output keys)
STEP_RECORDS = "step_records"   # [n, smax+4] int32, native.wfa_steps_to_ops
PACKED_RUNS = "packed_runs"     # [n, NRL] int16, native.wfa_runs_to_ops
# [n, R+4] int32: the step-record grammar with one level row a text
# position, native.wfa_steps_to_ops(max_score=read_size)
GENASM_RECORDS = "genasm_records"

_STREAMED = ("the streamed tier is not ported yet (ROADMAP Queue 1 item 7, "
             "kernels K6/K7)")
_XLA = ("the exact fallback tier is not ported yet (ROADMAP Queue 1 item 5)")


@dataclass(frozen=True)
class Tier:
    """A kernel tier: its wrapper, the record grammar it emits, and the
    device memory one pair holds during a call."""
    forward: Callable
    records: str
    device_bytes_per_pair: int

    def __call__(self, *args, **kw):
        return self.forward(*args, **kw)


def long_fit_nwswg(cfg: AlignConfig) -> bool:
    """Admission of the reference's streamed NW/SWG tier, copied from
    ``aim_tpu.ops.nwswg_pallas_long.long_fit_nwswg``: it names the ROADMAP
    item of the tier JAX routes an unported config to."""
    if cfg.algo != ALGO_NW and cfg.cell_width == 1:
        return False
    if cfg.algo == ALGO_NW:
        if min(cfg.gap_i, cfg.gap_d) <= 0:
            return False
    else:
        if cfg.gap_e <= 0 or cfg.match < 0:
            return False
    return 2 <= cfg.read_size <= 16352


def long_fit_genasm(cfg: AlignConfig) -> bool:
    """Admission of the reference's GenASM long tier, copied from
    ``aim_tpu.ops.genasm_long.long_fit_genasm``: k <= 2 * (band_c(4) - 1)
    = 508 (band_c(4) = 255) and the unit-cost NW config inside the
    streamed tier."""
    nw_cfg = AlignConfig(algo=ALGO_NW, read_size=cfg.read_size,
                         max_score=cfg.max_score, backtrace=cfg.backtrace,
                         gap_i=1, gap_d=1, mismatch=1, variant="hbm")
    return cfg.max_score <= 2 * (255 - 1) and long_fit_nwswg(nw_cfg)


def forward_fn(cfg: AlignConfig, packed_ok: bool = True) -> Tier:
    """The kernel tier that serves ``cfg``, routed as
    ``aim_tpu/ops/pallas_kernels.py::forward_fn`` routes it:

      * WFA: the short-read tier (K1) when ``vmem_fit2`` admits it, else
        the long-read tier (K5) when ``long_fit`` does in the batch's word
        layout (2-bit packed, or raw bytes when ``packed_ok`` is False);
      * NW: the short-read tier (K2) when ``vmem_fit_nw`` does (whatever
        the variant, as in JAX); SWG: the short-read tier (K3) under
        ``swg.admitted``;
      * GenASM: the short-read tier (K4) when ``vmem_fit_genasm`` admits
        it and the batch packs.

    ``packed_ok`` is False for a batch whose alphabet cannot 2-bit pack.
    The tier takes (pats, txts, plens, tlens, *, cfg, packed) tensors on
    one device."""
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
        return Tier(nw.nw_forward, PACKED_RUNS, nw.device_bytes_per_pair(cfg))
    if cfg.algo == ALGO_SWG and swg.admitted(cfg):
        return Tier(swg.swg_forward, PACKED_RUNS,
                    swg.device_bytes_per_pair(cfg))
    if cfg.algo in (ALGO_NW, ALGO_SWG):
        raise NotImplementedError(
            f"{cfg.algo} read_size={cfg.read_size} "
            f"max_score={cfg.max_score} match={cfg.match} "
            f"variant={cfg.variant} is outside the short-read tier: "
            + (_STREAMED if long_fit_nwswg(cfg) else _XLA))
    if cfg.algo == ALGO_GENASM:
        if packed_ok and genasm.vmem_fit_genasm(cfg):
            return Tier(genasm.genasm_forward, GENASM_RECORDS,
                        genasm.device_bytes_per_pair(cfg))
        raise NotImplementedError(
            f"genasm read_size={cfg.read_size} max_score={cfg.max_score} "
            f"packed={packed_ok} is outside the short-read tier: "
            + ("the GenASM long tier is not ported yet (ROADMAP Queue 1 "
               "item 7, kernels K6/K7)" if long_fit_genasm(cfg) else
               "the exact host tier is not ported yet (ROADMAP Queue 1 "
               "item 5)"))
    raise NotImplementedError(f"{cfg.algo}: unknown algorithm")
