"""h2d_gb_s: the wave loop's upload bytes (`h2d_bytes`: the four arrays of
each block, after packing) over its `upload` spans (the pinned staging,
the copies and the sync), GB/s (program counter and span)."""

import program_spans


def read(run):
    return program_spans.gb_s(run, "h2d_bytes", "upload")
