"""Vision-transformer encoders for the frozen conditioning models
(counterpart of ``pcdms_tpu/models/vit.py``).

One module covers both encoders of the reference:

  * OpenCLIP ViT-H/14 (``CLIPVisionModelWithProjection``): pre-LayerNorm,
    exact-GELU MLP, final LayerNorm on the CLS token, bias-free projection
    to the 1024-d image embedding. 16 heads of 80.
  * DINOv2-giant (``Dinov2Model``): LayerScale, SwiGLU FFN, final LayerNorm
    over the whole sequence; 257 x 1536 patch features at 224 px. 24 heads
    of 64.

The family is ``cfg.pre_layernorm`` (CLIP) or not (DINOv2), and it fixes the
state-dict names: HuggingFace's, so the JAX package's ``convert_clip_vision``
/ ``convert_dinov2`` read the port's ``state_dict()``. Attention goes
through the port's ``flash_attention`` router (under
``PCDMS_SHORTKV=pallas`` the short-kv kernel, at head_dim 64 or 80).
Position embeddings are resized with JAX's bicubic (Keys, a = -0.5, with
its antialiasing when downsampling), not ``F.interpolate``'s a = -0.75.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from pcdms_tpu_torch.nn.layers import Conv2d, LayerNorm, Linear, gelu
from pcdms_tpu_torch.ops.flash_attention import flash_attention_packed


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    hidden_size: int = 1280
    num_layers: int = 32
    num_heads: int = 16
    patch_size: int = 14
    image_size: int = 224
    mlp_ratio: float = 4.0
    layer_norm_eps: float = 1e-5
    pre_layernorm: bool = True        # CLIP: LN right after embeddings
    use_layer_scale: bool = False     # DINOv2
    use_swiglu: bool = False          # DINOv2-giant
    quick_gelu: bool = False          # some CLIP variants
    projection_dim: Optional[int] = None   # CLIP head: 1024
    patch_bias: bool = True           # CLIP: False, DINOv2: True
    use_flash: bool = True

    @property
    def num_patches(self):
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads

    @property
    def mlp_hidden(self):
        if self.use_swiglu:
            # HF Dinov2SwiGLUFFN: 2/3 * 4 * D rounded up to a multiple of 8
            h = int(self.hidden_size * self.mlp_ratio * 2 / 3)
            return ((h + 7) // 8) * 8
        return int(self.hidden_size * self.mlp_ratio)


def clip_vit_h14_config(use_flash: bool = True) -> ViTConfig:
    return ViTConfig(hidden_size=1280, num_layers=32, num_heads=16,
                     patch_size=14, image_size=224, projection_dim=1024,
                     pre_layernorm=True, patch_bias=False,
                     use_flash=use_flash)


def dinov2_giant_config(image_size: int = 224,
                        use_flash: bool = True) -> ViTConfig:
    return ViTConfig(hidden_size=1536, num_layers=40, num_heads=24,
                     patch_size=14, image_size=image_size,
                     layer_norm_eps=1e-6, pre_layernorm=False,
                     use_layer_scale=True, use_swiglu=True, patch_bias=True,
                     use_flash=use_flash)


class _Params(nn.Module):
    """Bare named parameters (HF's ``layer_scale*.lambda1``, CLIP's
    ``position_embedding.weight``)."""

    def __init__(self, **shapes):
        super().__init__()
        for name, shape in shapes.items():
            setattr(self, name, nn.Parameter(torch.ones(shape)))


def _linears(**dims):
    return nn.ModuleDict({k: Linear(*v) for k, v in dims.items()})


class ViTLayer(nn.Module):
    """Pre-norm encoder layer: x + ls1 * attn(norm1(x)), then
    x + ls2 * mlp(norm2(x))."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        d, h, eps = cfg.hidden_size, cfg.mlp_hidden, cfg.layer_norm_eps
        if cfg.pre_layernorm:      # CLIPEncoderLayer
            self.layer_norm1 = LayerNorm(d, eps=eps)
            self.self_attn = _linears(q_proj=(d, d), k_proj=(d, d),
                                      v_proj=(d, d), out_proj=(d, d))
            self.layer_norm2 = LayerNorm(d, eps=eps)
        else:                      # Dinov2Layer
            self.norm1 = LayerNorm(d, eps=eps)
            self.attention = nn.ModuleDict({
                "attention": _linears(query=(d, d), key=(d, d),
                                      value=(d, d)),
                "output": _linears(dense=(d, d))})
            self.norm2 = LayerNorm(d, eps=eps)
        if cfg.use_layer_scale:
            self.layer_scale1 = _Params(lambda1=(d,))
            self.layer_scale2 = _Params(lambda1=(d,))
        self.mlp = (_linears(weights_in=(d, 2 * h), weights_out=(h, d))
                    if cfg.use_swiglu else _linears(fc1=(d, h), fc2=(h, d)))

    def _attention_parts(self):
        if self.cfg.pre_layernorm:
            a = self.self_attn
            return (self.layer_norm1, a.q_proj, a.k_proj, a.v_proj,
                    a.out_proj, self.layer_norm2)
        a = self.attention
        return (self.norm1, a.attention.query, a.attention.key,
                a.attention.value, a.output.dense, self.norm2)

    def _mlp(self, x):
        if self.cfg.use_swiglu:
            x1, x2 = self.mlp.weights_in(x).chunk(2, dim=-1)
            return self.mlp.weights_out(F.silu(x1) * x2)
        h = self.mlp.fc1(x)
        h = h * torch.sigmoid(1.702 * h) if self.cfg.quick_gelu else gelu(h)
        return self.mlp.fc2(h)

    def forward(self, x):
        norm1, q, k, v, out, norm2 = self._attention_parts()
        y = norm1(x)
        h = out(flash_attention_packed(q(y), k(y), v(y), self.cfg.num_heads,
                                       use_flash=self.cfg.use_flash))
        if self.cfg.use_layer_scale:
            h = h * self.layer_scale1.lambda1.to(h.dtype)
        x = x + h
        h = self._mlp(norm2(x))
        if self.cfg.use_layer_scale:
            h = h * self.layer_scale2.lambda1.to(h.dtype)
        return x + h


class _Encoder(nn.Module):
    def __init__(self, cfg: ViTConfig, name: str):
        super().__init__()
        self.add_module(name, nn.ModuleList(
            [ViTLayer(cfg) for _ in range(cfg.num_layers)]))
        self._name = name

    def forward(self, x):
        for layer in getattr(self, self._name):
            x = layer(x)
        return x


class _Embeddings(nn.Module):
    """Patch embedding, CLS token and position embeddings, HF-named for
    the family."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        d, p, n = cfg.hidden_size, cfg.patch_size, cfg.num_patches + 1
        conv = Conv2d(3, d, p, stride=p, bias=cfg.patch_bias)
        if cfg.pre_layernorm:      # CLIPVisionEmbeddings
            self.class_embedding = nn.Parameter(torch.zeros(d))
            self.patch_embedding = conv
            self.position_embedding = _Params(weight=(n, d))
        else:                      # Dinov2Embeddings
            self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
            self.patch_embeddings = nn.ModuleDict({"projection": conv})
            self.position_embeddings = nn.Parameter(torch.zeros(1, n, d))

    def forward(self, pixels):
        """pixels: (B, H, W, 3) NHWC -> (B, 1 + gh*gw, D) with positions."""
        clip = self.cfg.pre_layernorm
        conv = (self.patch_embedding if clip
                else self.patch_embeddings.projection)
        patches = conv(pixels.permute(0, 3, 1, 2))
        b, d, gh, gw = patches.shape
        tokens = patches.flatten(2).transpose(1, 2)
        cls = (self.class_embedding.reshape(1, 1, d) if clip
               else self.cls_token).to(tokens.dtype).expand(b, 1, d)
        pos = (self.position_embedding.weight[None] if clip
               else self.position_embeddings)
        pos = interpolate_pos_embed(pos, gh, gw).to(tokens.dtype)
        return torch.cat([cls, tokens], dim=1) + pos


class VisionTransformer(nn.Module):
    """CLIP ViT-H (``cfg.pre_layernorm``) or DINOv2 encoder; ``forward``
    returns the ``vit_apply`` dict."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        if cfg.pre_layernorm:      # CLIPVisionModelWithProjection
            vm = nn.Module()
            vm.embeddings = _Embeddings(cfg)
            vm.pre_layrnorm = LayerNorm(d, eps=eps)
            vm.encoder = _Encoder(cfg, "layers")
            vm.post_layernorm = LayerNorm(d, eps=eps)
            self.vision_model = vm
            if cfg.projection_dim is not None:
                self.visual_projection = Linear(d, cfg.projection_dim,
                                                bias=False)
        else:                      # Dinov2Model
            if cfg.projection_dim is not None:
                raise ValueError("a DINOv2-family config has no projection")
            self.embeddings = _Embeddings(cfg)
            self.encoder = _Encoder(cfg, "layer")
            self.layernorm = LayerNorm(d, eps=eps)

    def forward(self, pixels):
        """pixels: (B, H, W, 3), already model-normalised.

        Returns {"last_hidden_state": (B, 1+N, D), "pooled": (B, D) the
        post-LN CLS token, "image_embeds": (B, proj_dim) if the model has a
        projection head}."""
        out = {}
        if self.cfg.pre_layernorm:
            vm = self.vision_model
            x = vm.encoder(vm.pre_layrnorm(vm.embeddings(pixels)))
            out["last_hidden_state"] = x
            pooled = vm.post_layernorm(x[:, 0])
        else:
            x = self.layernorm(self.encoder(self.embeddings(pixels)))
            out["last_hidden_state"] = x
            pooled = x[:, 0]
        out["pooled"] = pooled
        if hasattr(self, "visual_projection"):
            out["image_embeds"] = self.visual_projection(pooled)
        return out


def _keys_cubic(x):
    """Keys' cubic kernel, a = -0.5 (``jax.image``'s bicubic)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _resize_weights(n_in: int, n_out: int, device):
    """(n_in, n_out) f32 weights of ``jax.image.resize(method='bicubic')``
    along one axis: scale n_out / n_in, no translation, the kernel widened by
    1 / scale when downsampling (antialias), rows normalised, and samples
    outside the input zeroed (``compute_weight_mat``)."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device)
              + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32,
                                        device=device)[:, None]).abs()
    w = _keys_cubic(x / kernel_scale)
    total = w.sum(0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def interpolate_pos_embed(pos_embed, grid_h: int, grid_w: int):
    """Bicubic-resize (1, 1 + src*src, D) position embeddings to a
    (grid_h, grid_w) patch grid, the CLS position kept."""
    n = pos_embed.shape[1] - 1
    src = int(round(n ** 0.5))
    if src * src == n and (grid_h, grid_w) == (src, src):
        return pos_embed
    patch = pos_embed[0, 1:].float().reshape(src, src, -1)
    wh = _resize_weights(src, grid_h, pos_embed.device)
    ww = _resize_weights(src, grid_w, pos_embed.device)
    resized = torch.einsum("hwd,hy,wx->yxd", patch, wh, ww)
    resized = resized.reshape(1, grid_h * grid_w, -1).to(pos_embed.dtype)
    return torch.cat([pos_embed[:, :1], resized], dim=1)
