"""Plain reference of the PCDMs stage-2 trainer, in float32 with TF32 off:
the stage-2 loss (``stage2_train_inpaint_model.py``: VAE posterior samples
of the ground-truth and masked canvases, DDPM noising with the noise
offset, the 9-channel UNet with class embedding and pose map, epsilon MSE),
global-norm clipping and AdamW (decoupled decay, bias correction), as
``torch.optim.AdamW`` after ``optax.clip_by_global_norm`` define them.

Attention under autograd recomputes its scores in blocks in the backward
pass (``BlockedAttention``), and every resnet and transformer block of the
UNet is rematerialised in the backward pass, so 8192 tokens at batch 8 fit
on the card in f32, and in the control's float8 rounding too.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from benchmark.reference import nets as ref_nets
from benchmark.reference import sampling as ref_sampling

_BLOCK_BYTES = 1 << 30


class BlockedAttention(torch.autograd.Function):
    """softmax(q k^T * scale) v on (BH, L, d) f32 tensors; the backward pass
    rebuilds the softmax block by block from q, k, v and the output."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out = torch.empty_like(q)
        step = max(1, _BLOCK_BYTES // (q.shape[1] * k.shape[1] * 4))
        for i in range(0, q.shape[0], step):
            p = torch.softmax(torch.bmm(q[i:i + step],
                                        k[i:i + step].transpose(1, 2)) * scale,
                              dim=-1)
            out[i:i + step] = torch.bmm(p, v[i:i + step])
        ctx.save_for_backward(q, k, v, out)
        ctx.scale, ctx.step = scale, step
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out = ctx.saved_tensors
        scale, step = ctx.scale, ctx.step
        dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                      torch.empty_like(v))
        for i in range(0, q.shape[0], step):
            sl = slice(i, i + step)
            p = torch.softmax(torch.bmm(q[sl], k[sl].transpose(1, 2)) * scale,
                              dim=-1)
            dv[sl] = torch.bmm(p.transpose(1, 2), do[sl])
            dp = torch.bmm(do[sl], v[sl].transpose(1, 2))
            ds = p * (dp - (do[sl] * out[sl]).sum(-1, keepdim=True))
            dq[sl] = torch.bmm(ds, k[sl]) * scale
            dk[sl] = torch.bmm(ds.transpose(1, 2), q[sl]) * scale
        return dq, dk, dv, None


def _attention(q, k, v, heads: int):
    if not torch.is_grad_enabled():
        return ref_nets.plain_attention(q, k, v, heads)
    b, lq, hd = q.shape
    lk, d = k.shape[1], hd // heads

    def split(t, n):
        return t.reshape(b, n, heads, d).transpose(1, 2).reshape(
            b * heads, n, d).contiguous()

    o = BlockedAttention.apply(split(q, lq), split(k, lk), split(v, lk),
                               1.0 / math.sqrt(d))
    return o.reshape(b, heads, lq, d).transpose(1, 2).reshape(b, lq, hd)


class _Attention(ref_nets.Attention):
    def forward(self, x, ctx=None):
        ctx = x if ctx is None else ctx
        return self.to_out[0](_attention(self.to_q(x), self.to_k(ctx),
                                         self.to_v(ctx), self.heads))


class _Remat:
    """A block whose activations are recomputed in the backward pass."""

    def forward(self, *args):
        if torch.is_grad_enabled():
            return checkpoint(super().forward, *args, use_reentrant=False)
        return super().forward(*args)


_SWAPS = ((ref_nets.Attention, _Attention),
          (ref_nets.Resnet, type("Resnet", (_Remat, ref_nets.Resnet), {})),
          (ref_nets.Transformer2D,
           type("Transformer2D", (_Remat, ref_nets.Transformer2D), {})))


def trainable(nets: Dict[str, torch.nn.Module]) -> Dict[str, torch.nn.Module]:
    """Swap the UNet's attentions for the blocked-backward one and its
    resnet and transformer blocks for rematerialised ones (the same
    parameters); return the nets."""
    for m in nets["unet"].modules():
        for plain, swapped in _SWAPS:
            if type(m) is plain:
                m.__class__ = swapped
    return nets


def stage2_loss(nets, vae, batch: dict, draws: dict,
                noise_offset: float) -> torch.Tensor:
    """The stage-2 loss of one batch given its random draws (f32)."""
    ac = np.asarray(ref_sampling.sd21_alphas_cumprod(), np.float64)
    with torch.no_grad():
        z = []
        for img, key in ((batch["st_image"], "vae_gt"),
                         (batch["masked_image"], "vae_masked")):
            mean, logvar = vae.encode_moments(img)
            z.append((mean + torch.exp(0.5 * logvar) * draws[key])
                     * vae.scaling)
        latents, masked = z
    b, lh, lw, _ = latents.shape
    mask = ref_sampling.half_mask(lh, lw, latents.device).expand(b, -1, -1, -1)
    noise = draws["noise"] + noise_offset * draws["offset"]
    t = draws["timesteps"]
    sa = torch.as_tensor(np.sqrt(ac), dtype=torch.float32,
                         device=t.device)[t][:, None, None, None]
    s1 = torch.as_tensor(np.sqrt(1.0 - ac), dtype=torch.float32,
                         device=t.device)[t][:, None, None, None]
    noisy = sa * latents + s1 * noise
    unet_in = torch.cat([noisy, mask, masked], dim=-1)
    clip = batch["clip_embed"].float()
    ctx = torch.cat([nets["image_proj"](batch["dino_features"]), clip], dim=1)
    pred = nets["unet"](unet_in, t.float(), ctx, clip[:, 0],
                        nets["pose_proj"](batch["pose_image"]))
    return torch.mean(torch.square(pred - noise))


class AdamW:
    """Global-norm clipping (scale by max_norm / norm only when norm >=
    max_norm) then AdamW with decoupled weight decay and bias correction."""

    def __init__(self, params: List[torch.Tensor], lr, betas, eps,
                 weight_decay, max_grad_norm):
        self.params = params
        self.lr, self.betas, self.eps = lr, betas, eps
        self.wd, self.max_norm = weight_decay, max_grad_norm
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Update the parameters; returns the clipped gradients."""
        norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads))
        if float(norm) >= self.max_norm:
            grads = [g * (self.max_norm / float(norm)) for g in grads]
        self.t += 1
        b1, b2 = self.betas
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            p.mul_(1 - self.lr * self.wd)
            mh = m / (1 - b1 ** self.t)
            vh = v / (1 - b2 ** self.t)
            p.sub_(self.lr * mh / (vh.sqrt() + self.eps))
        return grads
