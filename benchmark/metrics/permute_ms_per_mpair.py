"""permute_ms_per_mpair: the program's `permute` spans (the inputs gathered
into the sort's order and the outputs gathered back) over the window's
batches, milliseconds a million pairs (program span)."""

import program_spans


def read(run):
    return program_spans.ms_per_mpair(run, "permute")
