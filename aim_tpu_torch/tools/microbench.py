"""Microbenchmark of the CUDA probes (``ops/probes.py``, ``csrc/probes.cu``):
what one rep of each primitive costs on this card.

The port of ``tools/microbench_mosaic.py``'s driver (:277-306).  For each
probe: its output at ``REPS_LO`` and ``REPS_HI`` reps must equal its plain
PyTorch version's byte for byte; then each rep count is timed, best of 3
with CUDA events over ``INNER`` launches back to back (a launch's time is
their mean), and the slope (t_hi - t_lo) / (reps_hi - reps_lo) is the cost
of one rep in ns, free of the launch overhead both times carry.
Beside it: the bound one rep could take (output elements x the body's
int32 operations over the card's int32 rate) and the plain version's time
at ``REPS_HI``.

    python -m aim_tpu_torch.tools.microbench [probe ...]

It needs a CUDA device; there is no CPU mode (a CPU time says nothing of
the card).
"""

from __future__ import annotations

import sys

import torch

from aim_tpu_torch.ops import probes
from aim_tpu_torch.tools import timing

REPS_LO, REPS_HI = 64, 512
INNER = 20   # launches a timed sample
# H100 SXM at its 700 W limit: 132 SMs x 64 INT32 lanes x 1.98 GHz boost
INT32_OPS_S = 132 * 64 * 1.98e9
# the floor of a device timing here: an event pair around an empty stream
# reads a few microseconds, a probe launch at least that
MIN_ANCHOR_S = 1e-6


def bound_ns_per_rep(name: str) -> float:
    """The least time one rep could take on the card: its int32
    operations (output elements x the body's operations) over the card's
    int32 rate."""
    pr = probes.PROBES[name]
    return probes.elements(name) * pr.ops_per_rep / INT32_OPS_S * 1e9


def check(name: str, device, reps: int) -> int:
    """The kernel's output against the plain version's at ``reps`` reps on
    the same inputs on ``device``: returns their max abs difference, and
    raises if it is not 0."""
    args = probes.inputs(name, device)
    got = probes.run(name, reps, *args)
    want = probes.PROBES[name].plain(reps, *args)
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"probe {name}: {got.shape} {got.dtype} "
                             f"against {want.shape} {want.dtype}")
    err = int((got.long() - want.long()).abs().max())
    if err:
        raise AssertionError(f"probe {name} at {reps} reps differs from its "
                             f"plain version (max abs diff {err})")
    return err


def measure(name: str, device="cuda") -> dict:
    """Check the probe at both rep counts, then time it: per-rep ns (the
    slope), the two times, the bound, the plain version's time at REPS_HI
    and the checks' max abs difference."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("the probes are timed on a CUDA device")
    err = max(check(name, device, reps) for reps in (REPS_LO, REPS_HI))
    args = probes.inputs(name, device)
    t = {}

    def timed(reps):
        t[reps] = timing.best_of(
            lambda: [probes.run(name, reps, *args) for _ in range(INNER)],
            repeats=3, device=device, min_anchor_s=MIN_ANCHOR_S) / INNER
        return t[reps]

    ns_per_rep = timing.marginal_us(timed, REPS_LO, REPS_HI) * 1e3
    plain = probes.PROBES[name].plain
    t_plain = timing.best_of(lambda: plain(REPS_HI, *args), repeats=1,
                             device=device, min_anchor_s=MIN_ANCHOR_S)
    return {"probe": name, "tpu_id": probes.PROBES[name].tpu_id,
            "ns_per_rep": ns_per_rep,
            "bound_ns_per_rep": bound_ns_per_rep(name),
            f"ms_{REPS_LO}": t[REPS_LO] * 1e3,
            f"ms_{REPS_HI}": t[REPS_HI] * 1e3,
            f"plain_ms_{REPS_HI}": t_plain * 1e3,
            "bound_ms": bound_ns_per_rep(name) * REPS_HI / 1e6,
            "max_abs_err": err}


def run(names=None, device="cuda", out=print) -> list:
    """Every probe of ``names`` (all by default): one line each; returns
    the ``measure`` dicts."""
    rows = []
    for name in names or list(probes.PROBES):
        m = measure(name, device)
        rows.append(m)
        out(f"{name:28s} {m['tpu_id']}  {m['ns_per_rep']:9.3f} ns/rep  "
            f"(bound {m['bound_ns_per_rep']:.3f}; "
            f"t{REPS_LO}={m[f'ms_{REPS_LO}']:.4f} ms "
            f"t{REPS_HI}={m[f'ms_{REPS_HI}']:.4f} ms; plain "
            f"t{REPS_HI}={m[f'plain_ms_{REPS_HI}']:.2f} ms)")
    return rows


def main(argv=None) -> int:
    names = (sys.argv[1:] if argv is None else argv) or None
    if not torch.cuda.is_available():
        print("microbench: needs a CUDA device", file=sys.stderr)
        return 2
    print(f"device: {torch.cuda.get_device_name(0)}", flush=True)
    run(names, torch.device("cuda", 0),
        out=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
