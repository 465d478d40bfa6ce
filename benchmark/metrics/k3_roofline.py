"""k3_roofline: K3's share of its roofline over the traced window: the
bound of the window's SWG work by the frozen counts of
`reference/swg.py::work` (band cells from the problem, bytes as
roofline.py counts them), over the device time of the kernels whose names
hold `swg_`: K3's two entry points, `swg_kernel` and `swg_seg_kernel<L>`
(device trace)."""

import roofline

KERNEL = "swg_"


def read(run):
    return roofline.share(run, KERNEL)
