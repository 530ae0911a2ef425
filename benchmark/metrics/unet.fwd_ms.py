"""Mean time of one UNet forward in the traced window (ms, CUDA events)."""


def read(run):
    if not run.unet_ms:
        return None
    return sum(run.unet_ms) / len(run.unet_ms)
