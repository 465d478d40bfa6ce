"""decode_ms_per_mpair: the program's `decode` spans (each chunk's records into
scores and CIGARs, retry and fallback excluded) over the window's batches,
milliseconds a million pairs (program span)."""

import program_spans


def read(run):
    return program_spans.ms_per_mpair(run, "decode")
