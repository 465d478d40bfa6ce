"""Backend dispatch: the port's counterpart of
``aim_tpu/ops/pallas_kernels.py::forward_fn``.

``forward_fn(cfg)`` returns the kernel tier that serves a config the port
has ported, admitted exactly as the reference admits it, and raises
``NotImplementedError`` naming the ROADMAP item for every other config.
It never hands a config to the host oracle.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from aim_tpu.config import ALGO_GENASM, ALGO_NW, ALGO_SWG, ALGO_WFA, \
    AlignConfig
from aim_tpu_torch.ops import nw, swg, wfa2

# record grammars (the reference's output keys)
STEP_RECORDS = "step_records"   # [n, smax+4] int32, native.wfa_steps_to_ops
PACKED_RUNS = "packed_runs"     # [n, NRL] int16, native.wfa_runs_to_ops

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


def forward_fn(cfg: AlignConfig) -> Tier:
    """The kernel tier that serves ``cfg``: the WFA short-read tier (K1)
    when ``vmem_fit2`` admits it, the NW short-read tier (K2) when
    ``vmem_fit_nw`` does (whatever the variant, as in JAX), the SWG
    short-read tier (K3) under ``swg.admitted``.  The tier takes (pats,
    txts, plens, tlens, *, cfg, packed) tensors on one device."""
    if cfg.algo == ALGO_WFA:
        if wfa2.vmem_fit2(cfg):
            return Tier(wfa2.wfa_forward2, STEP_RECORDS,
                        wfa2.device_bytes_per_pair(cfg))
        raise NotImplementedError(
            f"WFA read_size={cfg.read_size} max_score={cfg.max_score} is "
            "outside the short-read tier: the WFA long-read tier is not "
            "ported yet (ROADMAP Queue 1 item 6, kernel K5)")
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
        raise NotImplementedError(
            "genasm: not ported yet: GenASM short-read tier (ROADMAP "
            "Queue 1 item 4, kernel K4)")
    raise NotImplementedError(f"{cfg.algo}: unknown algorithm")
