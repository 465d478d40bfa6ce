"""plan_ms_per_mpair: the program's `plan` spans (the chunk plan with its
cudaMemGetInfo, and the result arrays' allocation) over the window's
batches, milliseconds a million pairs (program span)."""

import program_spans


def read(run):
    return program_spans.ms_per_mpair(run, "plan")
