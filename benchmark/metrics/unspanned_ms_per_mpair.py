"""unspanned_ms_per_mpair: each batch's wall time less every stage span of
the program's call, milliseconds a million pairs: the time no span
covers, inside the call or outside it (host clock and program spans)."""

import program_spans


def read(run):
    tail = program_spans.rows(run)
    if tail is None:
        return None
    wall = sum(b["wall_s"] for b in run.batches)
    return (wall - program_spans.spanned_s(tail)) * 1e3 \
        / (float(tail["pairs"].sum()) / 1e6)
