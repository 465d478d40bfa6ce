"""k7_roofline: K7's share of its roofline over the traced window: the
bytes of the window's pairs as roofline.py counts them (2-bit bases in,
a 4-byte score, 2-bit CIGAR ops out), the walk's frozen work, with no
operations counted, over the device time of the kernels whose names hold
`walk_kernel`: K7's `walk_kernel<kSwg, CWL>` (device trace)."""

import roofline

KERNEL = "walk_kernel"


def read(run):
    if run.trace is None:
        return None
    dev_s = sum(v for k, v in run.trace["device_s_by_name"].items()
                if KERNEL in k)
    if dev_s <= 0 or not run.batches:
        return None
    n_bytes = sum(roofline.wfa_bytes(*run.entry.lengths[b["unit"]])
                  for b in run.batches)
    bound = roofline.bound_s(n_bytes, 0, run.card)
    return None if bound is None else 100.0 * bound / dev_s
