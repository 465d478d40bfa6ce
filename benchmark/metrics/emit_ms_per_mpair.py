"""emit_ms_per_mpair: the program's `emit` spans (native.emit_output, the
output file written) over the window's batches, milliseconds a million pairs
(program span)."""

import program_spans


def read(run):
    return program_spans.ms_per_mpair(run, "emit")
