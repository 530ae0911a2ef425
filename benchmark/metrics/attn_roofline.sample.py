"""The attention calls that the program routes to its kernels: their
least time (``kernels/attention/*.json``: the larger of the operations
over the bf16 peak and the bytes over the HBM peak) over the device time
of the kernels that implement them (%)."""

from benchmark import roofline


def read(run):
    return roofline.share(run, "attention")
