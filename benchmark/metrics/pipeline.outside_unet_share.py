"""Share of the traced window not covered by UNet forwards (%): the
conditions, the VAE, the sampler's arithmetic and the host's gaps. The
forwards are timed by CUDA events from hooks on the UNet module."""


def read(run):
    if not run.unet_ms or not run.window_s:
        return None
    return 100.0 * (1.0 - sum(run.unet_ms) / 1e3 / run.window_s)
