"""VAE pre-training loss (counterpart of ``pcdms_tpu/train/vae.py``).

The reference never trains its VAE: it ships SD-2.1's frozen autoencoder.
The tiny configurations have no pretrained autoencoder, and a random
decoder makes every pixel output noise however well the UNets learn, so the
tiny VAE is first fitted with this loss: the posterior sample's
reconstruction MSE plus a small KL term, the stable-diffusion autoencoder's
loss without its adversarial and perceptual parts.

As ``train/stage2.py`` does, the loss is split: ``vae_draws`` makes its one
random input from a ``torch.Generator`` and ``vae_pretrain_loss`` is
deterministic given it.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def vae_draws(generator: Optional[torch.Generator], batch_size: int,
              latent_hw, latent_channels: int = 4,
              device=None) -> Dict[str, torch.Tensor]:
    """``noise`` (B, h, w, latent_channels): the posterior sample's f32
    standard normal."""
    return {"noise": torch.randn((batch_size, *latent_hw, latent_channels),
                                 generator=generator, device=device)}


def vae_pretrain_loss(vae, batch, draws, kl_weight: float = 1e-6,
                      compute_dtype: torch.dtype = torch.float32):
    """Deterministic loss of ``vae`` (trained, so it is the module itself,
    run in ``compute_dtype``) on ``batch["image"]`` (B, H, W, 3) in
    [-1, 1]. Returns (f32 loss, {"loss", "mse", "kl"})."""
    x = batch["image"].to(compute_dtype)
    mean, logvar = vae.encode_moments(x)
    z = mean + torch.exp(0.5 * logvar) * draws["noise"].to(mean.dtype)
    recon = vae.decode(z * vae.cfg.scaling_factor)
    mse = torch.mean(torch.square(recon.float() - x.float()))
    kl = 0.5 * torch.mean(torch.sum(
        torch.square(mean) + torch.exp(logvar) - 1.0 - logvar,
        dim=(1, 2, 3)).float())
    loss = mse + kl_weight * kl
    return loss, {"loss": loss.detach(), "mse": mse.detach(),
                  "kl": kl.detach()}
