"""k6_roofline: K6's share of its roofline over the traced window: the
bound of the window's NW work by the frozen counts of
`reference/nw.py::work` (8 int32 ops a cell of the exact score's band;
bytes as roofline.py counts them), over the device time of the kernels
whose names hold `fwd_kernel`: K6's `fwd_kernel<E, kSwg>` at every plane
count, the ladder's wider bands included (device trace)."""

import roofline

KERNEL = "fwd_kernel"


def read(run):
    return roofline.share(run, KERNEL)
