"""pack_ms_per_mpair: the program's `pack` spans (pack_seqs and the tier pick)
over the window's batches, milliseconds a million pairs (program span)."""

import program_spans


def read(run):
    return program_spans.ms_per_mpair(run, "pack")
