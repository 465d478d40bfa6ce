"""sort_ms_per_mpair: the program's `sort` spans (the difficulty order and its
dealing over cards) over the window's batches, milliseconds a million pairs
(program span)."""

import program_spans


def read(run):
    return program_spans.ms_per_mpair(run, "sort")
