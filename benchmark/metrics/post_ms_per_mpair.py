"""post_ms_per_mpair: each batch's wall time less the program's parse,
load, kernel and retrieve spans, milliseconds a million pairs: decode,
the retry and fallback passes and emit (in an api batch, decode alone)."""

import stats


def read(run):
    if not run.batches:
        return None
    keys = ("parse_ms", "load_ms", "kernel_ms", "retrieve_ms")
    if any(b.get(k) is None for b in run.batches for k in keys[1:]):
        return None
    rest = sum(b["wall_s"] * 1e3 - sum(b.get(k) or 0.0 for k in keys)
               for b in run.batches)
    return rest / (sum(b["pairs"] for b in run.batches) / 1e6)
