"""k4_roofline: K4's share of its roofline over the traced window: the
bound of the window's GenASM work by the frozen counts of
`reference/genasm.py::work` (32-bit words of the pattern's bits, each
distance level, each text position; bytes as roofline.py counts them),
over the device time of the kernels whose names hold `genasm_`: K4's two
entry points, `genasm_seg_kernel<S>` and `genasm_wide_kernel` (device
trace)."""

import roofline

KERNEL = "genasm_"


def read(run):
    return roofline.share(run, KERNEL)
