"""fallback_ms_per_mpair: the program's `fallback` spans (the exact host
oracle on the pairs the ladder left flagged) over the window's batches,
milliseconds a million pairs; None where no batch reached the oracle
(program span)."""

import program_spans


def read(run):
    value = program_spans.ms_per_mpair(run, "fallback")
    return value or None
