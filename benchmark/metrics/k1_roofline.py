"""k1_roofline: K1's share of its roofline over the traced window: the
bound of the window's WFA work by the frozen counts of roofline.py, over
the device time of the kernels named `wfa2_kernel` (device trace)."""

import roofline

KERNEL = "wfa2_kernel"


def read(run):
    return roofline.share(run, KERNEL)
