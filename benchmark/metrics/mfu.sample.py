"""The traced window's useful operations (``flops.py``: the UNet at every
step, the VAE, the projections) over its time and the card's bf16 peak
(%)."""


def read(run):
    peak = run.peaks.get("bf16_flops")
    if not peak or not run.window_work or not run.window_s:
        return None
    return 100.0 * run.window_work / (run.window_s * peak)
