"""d2h_gb_s: the wave loop's record bytes (`d2h_bytes`) over its
`retrieve` spans (`.cpu().numpy()` into pageable memory), GB/s (program
counter and span)."""

import program_spans


def read(run):
    return program_spans.gb_s(run, "d2h_bytes", "retrieve")
