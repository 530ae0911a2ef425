"""The training attention calls that the program routes to its kernels
(the LSE forward, dq and dk/dv): their least time
(``kernels/attention_train/*.json``) over the device time of those
kernels (%)."""

from benchmark import roofline


def read(run):
    return roofline.share(run, "attention_train")
