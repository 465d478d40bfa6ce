"""Alignment configuration and launcher-parity config derivation.

The port's own copy of ``aim_tpu/config.py`` (the port imports nothing of
the JAX package; tests hold the two equal).  The reference drives
everything through compile-time ``-D`` macros computed by the per-variant
Python launchers (ref: WFA/DPU-MRAM/run-wfa-pim-mram.py,
NW/DPU-WRAM/run-nw-pim-wram.py, SWG/DPU-WRAM/run-swg-pim-wram.py).  Here the
same quantities become fields of a frozen dataclass that selects a kernel
tier and its geometry.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass


def round_up_multiple_8(x: int) -> int:
    """ref: common.h ROUND_UP_MULTIPLE_8."""
    return ((int(x) + 7) // 8) * 8


def launcher_pad8(x: float) -> int:
    """The launchers' padding formula ``ceil((x + 7) / 8) * 8`` with FLOAT
    division (ref: run-wfa-pim-mram.py:67).  NOT the same as roundup8 for
    non-multiples-of-8: launcher_pad8(101) == 112 while roundup8(101) == 104.
    This reproduces the reference's canonical READ_SIZE=112 for l=100 e=1%.
    """
    return int(math.ceil((x + 7) / 8)) * 8


ALGO_NW = "nw"
ALGO_SWG = "swg"
ALGO_WFA = "wfa"
# GenASM: bitvector bounded-edit-distance family.  The reference ships it
# only as an empty submodule (.gitmodules:1-3); aim-tpu implements it with
# clean Levenshtein semantics anchored to the NW walker at unit costs
# (golden/genasm.py).
ALGO_GENASM = "genasm"

VALID_ALGOS = (ALGO_NW, ALGO_SWG, ALGO_WFA, ALGO_GENASM)

# The reference's WFA offsets are int16 with NULL = INT16_MIN/2
# (ref: WFA/DPU-MRAM/common/common.h:98-100).
OFFSET_NULL_16 = -(2 ** 15) // 2  # -16384
OFFSET_NULL_32 = -(2 ** 31) // 2
# SWG sentinel (ref: SWG/DPU-WRAM/common/common.h SWG_OFFSET_NULL); unused by
# the compute path but kept for completeness.
SWG_OFFSET_NULL_8 = -(2 ** 7) // 2


@dataclass(frozen=True)
class AlignConfig:
    """Static alignment parameters — one instance per (algo, costs, shapes).

    Mirrors the reference's per-build macro set:
    MATCH/MISMATCH/GAP_O/GAP_E (WFA, SWG) or GAP_I/GAP_D (NW),
    MAX_SCORE, READ_SIZE, BACKTRACE, REDUCE
    (ref: WFA/DPU-MRAM/common/common.h:64-90, Makefile FLAGS).
    """

    algo: str = ALGO_WFA
    # Cost model. NW uses gap_i/gap_d + mismatch; SWG/WFA use
    # match/mismatch/gap_o/gap_e.
    match: int = 0
    mismatch: int = 3
    gap_o: int = 4
    gap_e: int = 1
    gap_i: int = 4
    gap_d: int = 4
    # Static shape bounds.
    read_size: int = 112          # padded max sequence length (READ_SIZE)
    max_score: int = 5            # WFA score cap / SWG init sentinel
    # Feature flags.
    backtrace: bool = False       # -DBACKTRACE
    adaptive: bool = False        # -DREDUCE (WFA-adaptive)
    # WFA WRAM-variant overflow-backtrace compat (opt-in): emit a
    # defined best-effort CIGAR for score > MAX_SCORE pairs instead of
    # the MRAM-variant skip.  The reference's WRAM tier backtraces on
    # overflow through an out-of-bounds wavefront read (UB, ref:
    # WFA/DPU-WRAM/dpu/wfa.c:369-376), so no bit-exact target exists;
    # the rendition walks from the deepest live computed level
    # (oracle.cpp aim_wfa_align / golden.wfa_golden).
    overflow_backtrace: bool = False
    # Memory tier: 'vmem' keeps all per-pair alignment state on-chip
    # (the reference's DPU-WRAM variants); 'hbm' spills wavefront /
    # traceback state to HBM (the DPU-MRAM variants).  Semantics are
    # identical except where the reference's variants themselves diverge
    # (WFA overflow backtrace; see ops/wfa*.py).
    variant: str = "vmem"
    # Kernel backend: 'auto' | 'pallas' | 'xla'.
    backend: str = "auto"
    # Per-device pair-batch tile (pairs aligned concurrently per kernel
    # launch).  The analogue of NR_TASKLETS × pairs-per-tasklet.
    batch_pairs: int = 16384

    # ---- derived dtype policy ------------------------------------------
    @property
    def cell_width(self) -> int:
        """DP cell byte width.

        NW: always int16 (NW_W16 hard-coded, ref: NW/*/common/common.h:87).
        SWG: int8 iff MAX_SCORE < 127 in the WRAM variant, int16 in the
        MRAM variant (ref: SWG/DPU-WRAM/common/common.h:71-75 vs MRAM diff).
        WFA: offsets int16 iff read_size < 32767
        (ref: run-wfa-pim-mram.py:62-65).
        """
        if self.algo in (ALGO_NW, ALGO_GENASM):
            return 2
        if self.algo == ALGO_SWG:
            if self.variant == "vmem" and self.max_score < 127:
                return 1
            return 2
        return 2 if self.read_size < 32767 else 4

    @property
    def offset_null(self) -> int:
        if self.cell_width == 2:
            return OFFSET_NULL_16
        if self.cell_width == 4:
            return OFFSET_NULL_32
        return SWG_OFFSET_NULL_8

    @property
    def max_operations_bound(self) -> int:
        """Per-pair traceback ops buffer size (ref: wfa.c:499 '2*READ_SIZE')."""
        return 2 * self.read_size

    def validate(self) -> "AlignConfig":
        if self.algo not in VALID_ALGOS:
            raise ValueError(f"unknown algo {self.algo!r}; want one of {VALID_ALGOS}")
        if self.variant not in ("vmem", "hbm"):
            raise ValueError(f"unknown variant {self.variant!r}")
        if self.backend not in ("auto", "pallas", "xla"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.read_size <= 0 or self.read_size % 8 != 0:
            raise ValueError("read_size must be a positive multiple of 8 "
                             "(ref launcher pads with roundup8)")
        if self.algo in (ALGO_SWG, ALGO_WFA):
            # ref: run-wfa-pim-mram.py:44-46 penalty validation
            if self.match > 0 or self.mismatch <= 0 or self.gap_o <= 0 or self.gap_e <= 0:
                raise ValueError(
                    "wrong affine gap penalties: must be m <= 0 and g, a, x > 0")
        if self.algo == ALGO_NW and (self.mismatch <= 0 or self.gap_i <= 0 or self.gap_d <= 0):
            raise ValueError("NW penalties must be positive (x, g > 0)")
        if self.algo == ALGO_GENASM and self.max_score < 0:
            raise ValueError("GenASM edit threshold must be >= 0")
        return self

    def replace(self, **kw) -> "AlignConfig":
        return dataclasses.replace(self, **kw).validate()


def wram_feasible(cfg: AlignConfig) -> bool:
    """The reference WRAM launchers' per-tasklet memory model (1 tasklet):
    a config the reference's short-read (DPU-WRAM) tier cannot hold is not
    a valid 'vmem' config here either — the tiers must mean the same
    thing, and e.g. SWG's int8 cells only exist in WRAM-feasible sizes.

    ref: run-nw-pim-wram.py:63 (l^2*cell table), run-swg-pim-wram.py:68-70
    (3 matrices), run-wfa-pim-wram.py:70-85 (all wavefronts live);
    budget 62000 - 1024 stack (run-*-wram.py tasklet loop).
    """
    R = cfg.read_size
    if cfg.algo == ALGO_GENASM:
        # No reference WRAM envelope exists for GenASM (empty submodule);
        # the device-tier gate is ops/genasm_pallas.vmem_fit_genasm and
        # oversize configs serve from the exact host tier.
        return True
    if cfg.algo == ALGO_NW:
        bound = 100 + 2 * R + R * R * 2
    elif cfg.algo == ALGO_SWG:
        bound = 100 + 2 * R + R * R * cfg.cell_width * 3
    else:
        s = cfg.max_score
        # all wavefronts of all scores live in WRAM: <= (s+1) components,
        # each 3 arrays of up to (2s+1) offsets (+ header), adaptive keeps
        # the same worst case bound (ref run-wfa-pim-wram.py:70-85).
        bound = 100 + 2 * R + (s + 1) * (3 * (2 * s + 1) * cfg.cell_width + 32)
    if cfg.backtrace:
        bound += 2 * R
    return bound < 62000 - 1024


def derive_config(
    algo: str,
    read_length: int,
    error: float,
    match: int = 0,
    mismatch: int = 3,
    gap_opening: int = 4,
    gap_extending: int = 1,
    gap: int | None = None,
    backtrace: bool = False,
    adaptive: bool = False,
    variant: str = "vmem",
    **overrides,
) -> AlignConfig:
    """Derive MAX_SCORE / READ_SIZE exactly like the reference launchers.

    WFA/SWG (ref: run-wfa-pim-mram.py:58-67, run-swg-pim-wram.py:54-65):
        wrong = l * e
        MAX_SCORE = ceil(max(wrong * x, wrong * (o + a)))
        READ_SIZE = roundup8(l + wrong)
    NW (ref: run-nw-pim-wram.py:51-60): same with o+a -> g+g and
    GAP_I = GAP_D = g (run-nw-pim-wram.py:121-123).
    """
    if algo not in VALID_ALGOS:
        raise ValueError(f"unknown algo {algo!r}")
    if read_length <= 0:
        raise ValueError("undefined input read length")
    wrong = read_length * error
    if algo == ALGO_GENASM:
        # unit costs: the NW formula with x = g = 1 -> ceil(2 * wrong)
        cfg = AlignConfig(
            algo=algo,
            match=0,
            mismatch=1,
            gap_i=1,
            gap_d=1,
            read_size=launcher_pad8(read_length + wrong),
            max_score=int(math.ceil(2 * wrong)),
            backtrace=backtrace,
            adaptive=False,
            variant=variant,
        )
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        return cfg.validate()
    if algo == ALGO_NW:
        g = gap_opening if gap is None else gap
        max_score = math.ceil(max(wrong * mismatch, wrong * (g + g)))
        cfg = AlignConfig(
            algo=algo,
            match=match,
            mismatch=mismatch,
            gap_i=g,
            gap_d=g,
            read_size=launcher_pad8(read_length + wrong),
            max_score=int(max_score),
            backtrace=backtrace,
            adaptive=False,
            variant=variant,
        )
    else:
        max_score = math.ceil(max(wrong * mismatch, wrong * (gap_opening + gap_extending)))
        cfg = AlignConfig(
            algo=algo,
            match=match,
            mismatch=mismatch,
            gap_o=gap_opening,
            gap_e=gap_extending,
            read_size=launcher_pad8(read_length + wrong),
            max_score=int(max_score),
            backtrace=backtrace,
            adaptive=adaptive and algo == ALGO_WFA,
            variant=variant,
        )
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg.validate()
