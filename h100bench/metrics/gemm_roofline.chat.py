"""gemm_roofline.chat: the GEMM launches' bounds over gemm_kernel's device
time, in % (h100bench/layers.py:gemm_roofline)."""

from h100bench import layers


def read(run):
    return layers.gemm_roofline(run)
