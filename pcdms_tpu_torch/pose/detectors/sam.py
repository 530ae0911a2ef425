"""Segment Anything (SAM) as ``nn.Module``s, NCHW (counterpart of
``pcdms_tpu/pose/detectors/sam.py``).

controlnet-aux's ``segment_anything`` under the published key names of
``sam_vit_{h,l,b}_*.pth`` and MobileSAM's ``mobile_sam.pt``
(``image_encoder.*``, ``prompt_encoder.*``, ``mask_decoder.*``):

  * the ViTDet-style image encoder: a stride-16 patch embed and an absolute
    position table, blocks with windowed (14) or global attention and the
    decomposed relative-position bias (plain ``softmax(q k^T / sqrt(d) +
    bias) v`` in f32: head_dim 80 at vit_h, with a bias), a 1x1 conv ->
    LayerNorm2d -> 3x3 conv -> LayerNorm2d neck; or MobileSAM's TinyViT
    (``tiny_vit.py``);
  * the random-Fourier prompt encoder (``dense_pe``, ``embed_points``);
  * the two-way transformer mask decoder with hypernetwork mask heads and
    the IoU head.

Configurations mirror ``build_sam.py``: vit_h (1280 / 32 / 16, global
blocks 7 / 15 / 23 / 31), vit_l (1024 / 24 / 16), vit_b (768 / 12 / 12),
vit_t (TinyViT-5M), all with 1024 px inputs and a 256-d prompt / mask
space. The published files' keys this port does not read (the prompt
encoder's mask downscaling, TinyViT's classifier head) are dropped at load.
The automatic mask generator and the detector facade live in
``sam_amg.py``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

PROMPT_DIM = 256
IMG_SIZE = 1024
WINDOW = 14
MASK_TOKENS = 4                       # 1 single-mask + 3 multimask
DECODER_HEADS = 8
PIXEL_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
PIXEL_STD = np.array([58.395, 57.12, 57.375], np.float32)


class SamConfig(NamedTuple):
    dim: int = 1280
    depth: int = 32
    heads: int = 16
    global_blocks: Tuple[int, ...] = (7, 15, 23, 31)
    img_size: int = IMG_SIZE
    tiny: bool = False                # the encoder is MobileSAM's TinyViT


SAM_CONFIGS = {
    "vit_h": SamConfig(1280, 32, 16, (7, 15, 23, 31)),
    "vit_l": SamConfig(1024, 24, 16, (5, 11, 17, 23)),
    "vit_b": SamConfig(768, 12, 12, (2, 5, 8, 11)),
    # MobileSAM TinyViT-5M: dim / depth / heads are informational
    "vit_t": SamConfig(320, 10, 10, (), IMG_SIZE, True),
}


def sam_config(sd) -> SamConfig:
    """The configuration of a published state dict, as ``convert_sam``
    infers it: the TinyViT key means vit_t; otherwise the patch embed's
    width (1280 / 1024 / 768) picks vit_h / vit_l / vit_b."""
    if "image_encoder.layers.0.blocks.0.conv1.c.weight" in sd:
        return SAM_CONFIGS["vit_t"]
    dim = sd["image_encoder.patch_embed.proj.weight"].shape[0]
    return {1280: SAM_CONFIGS["vit_h"], 1024: SAM_CONFIGS["vit_l"],
            768: SAM_CONFIGS["vit_b"]}[dim]


class LayerNorm2d(nn.Module):
    """Per-pixel normalisation over the channel axis of (B, C, H, W),
    divided by ``sqrt(var + eps)`` (``common.py::LayerNorm2d``)."""

    def __init__(self, c: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.eps = eps

    def forward(self, x):
        mean = x.mean(1, keepdim=True)
        var = ((x - mean) ** 2).mean(1, keepdim=True)
        x = (x - mean) / torch.sqrt(var + self.eps)
        return x * self.weight[:, None, None] + self.bias[:, None, None]


def neck(dim: int) -> nn.Sequential:
    """The 1x1 conv -> LayerNorm2d -> 3x3 conv -> LayerNorm2d neck to the
    256-d embedding (``neck.{0,1,2,3}``)."""
    return nn.Sequential(
        nn.Conv2d(dim, PROMPT_DIM, 1, bias=False), LayerNorm2d(PROMPT_DIM),
        nn.Conv2d(PROMPT_DIM, PROMPT_DIM, 3, padding=1, bias=False),
        LayerNorm2d(PROMPT_DIM))


# ---------------------------------------------------------------------------
# image encoder
# ---------------------------------------------------------------------------

def decomposed_rel_pos(q, rel_h, rel_w, hw: Tuple[int, int]):
    """``add_decomposed_rel_pos``'s bias for the square q == k case: q
    (B*, N, hd) -> (B*, N, N). The tables must fit the grid (2 h - 1 rows):
    SAM pads its inputs to the fixed grid and never interpolates them."""
    h, w = hw
    if rel_h.shape[0] != 2 * h - 1 or rel_w.shape[0] != 2 * w - 1:
        raise ValueError(
            f"relative-position tables of {rel_h.shape[0]} / "
            f"{rel_w.shape[0]} rows for a {h}x{w} grid: SAM inputs are "
            "padded to the fixed grid, the tables are never interpolated")
    idx_h = np.arange(h)[:, None] - np.arange(h)[None, :] + (h - 1)
    idx_w = np.arange(w)[:, None] - np.arange(w)[None, :] + (w - 1)
    rh = rel_h[torch.from_numpy(idx_h.reshape(-1)).to(q.device)].reshape(
        h, h, -1)
    rw = rel_w[torch.from_numpy(idx_w.reshape(-1)).to(q.device)].reshape(
        w, w, -1)
    rq = q.reshape(q.shape[0], h, w, -1)
    bias_h = torch.einsum("bhwc,hkc->bhwk", rq, rh)
    bias_w = torch.einsum("bhwc,wkc->bhwk", rq, rw)
    return (bias_h[:, :, :, :, None] + bias_w[:, :, :, None, :]).reshape(
        q.shape[0], h * w, h * w)


class Attention(nn.Module):
    """Multi-head attention on a (B, H, W, C) grid with the decomposed
    relative-position bias; ``input_size`` sizes the bias tables."""

    def __init__(self, dim: int, heads: int, input_size: int):
        super().__init__()
        self.heads = heads
        hd = dim // heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size - 1, hd))

    def forward(self, x):
        b, h, w, c = x.shape
        n, hd = h * w, c // self.heads
        qkv = self.qkv(x.reshape(b, n, c)).reshape(b, n, 3, self.heads, hd)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).reshape(
            3, b * self.heads, n, hd).unbind(0)
        attn = (q / math.sqrt(hd)) @ k.transpose(1, 2)
        # at a global block 16 x 4096^2 f32 each: the bias is added in
        # place and both are freed as soon as the softmax has them
        attn += decomposed_rel_pos(q, self.rel_pos_h, self.rel_pos_w, (h, w))
        attn = torch.softmax(attn, -1)
        o = (attn @ v).reshape(b, self.heads, n, hd).transpose(1, 2)
        return self.proj(o.reshape(b, h, w, c))


def window_partition(x, ws: int):
    """(B, H, W, C) zero-padded to multiples of ``ws`` -> ((B * windows,
    ws, ws, C), the padded (H, W))."""
    b, h, w, c = x.shape
    pad_h, pad_w = (ws - h % ws) % ws, (ws - w % ws) % ws
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // ws, ws, wp // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c), (hp, wp)


def window_unpartition(wins, ws: int, pad_hw, hw):
    hp, wp = pad_hw
    h, w = hw
    b = wins.shape[0] // (hp * wp // ws // ws)
    x = wins.reshape(b, hp // ws, wp // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)[:, :h, :w]


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int, act=F.gelu):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)
        self.act = act

    def forward(self, x):
        return self.lin2(self.act(self.lin1(x)))


class Block(nn.Module):
    """Pre-LN block: windowed (``window`` > 0; the LayerNorm'd tokens are
    padded with zeros and cropped back before the residual) or global
    attention, then a GELU MLP."""

    def __init__(self, dim: int, heads: int, window: int, grid: int):
        super().__init__()
        self.window = window
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads, window if window > 0 else grid)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, 4 * dim)

    def forward(self, x):
        h = self.norm1(x)
        if self.window > 0:
            hw = h.shape[1:3]
            h, pad_hw = window_partition(h, self.window)
        h = self.attn(h)
        if self.window > 0:
            h = window_unpartition(h, self.window, pad_hw, hw)
        x = x + h
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, 16, 16)


class ImageEncoderViT(nn.Module):
    """(B, 3, S, S) pixel-normalised -> (B, 256, S / 16, S / 16)."""

    def __init__(self, cfg: SamConfig):
        super().__init__()
        grid = cfg.img_size // 16
        self.patch_embed = PatchEmbed(cfg.dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, cfg.dim))
        self.blocks = nn.ModuleList([
            Block(cfg.dim, cfg.heads,
                  0 if i in cfg.global_blocks else WINDOW, grid)
            for i in range(cfg.depth)])
        self.neck = neck(cfg.dim)

    def forward(self, x):
        h = self.patch_embed.proj(x).permute(0, 2, 3, 1) + self.pos_embed
        for blk in self.blocks:
            h = blk(h)
        return self.neck(h.permute(0, 3, 1, 2))


# ---------------------------------------------------------------------------
# prompt encoder (points and the dense no-mask embedding)
# ---------------------------------------------------------------------------

class PositionEmbeddingRandom(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix",
                             torch.randn(2, PROMPT_DIM // 2))

    def encode(self, coords01):
        """``_pe_encoding`` of [0, 1] coordinates (..., 2) -> (..., 256)."""
        c = (2.0 * coords01 - 1.0) @ self.positional_encoding_gaussian_matrix
        c = (2.0 * np.pi) * c
        return torch.cat([torch.sin(c), torch.cos(c)], -1)


class PromptEncoder(nn.Module):
    """The parts of the prompt encoder the point prompts read: the Fourier
    features, the point / box-corner embeddings, the pad point and the
    no-mask embedding."""

    def __init__(self):
        super().__init__()
        self.pe_layer = PositionEmbeddingRandom()
        self.point_embeddings = nn.ModuleList(
            [nn.Embedding(1, PROMPT_DIM) for _ in range(4)])
        self.not_a_point_embed = nn.Embedding(1, PROMPT_DIM)
        self.no_mask_embed = nn.Embedding(1, PROMPT_DIM)


def dense_pe(prompt: PromptEncoder, size: Tuple[int, int] = (64, 64)):
    """The image grid's positional encoding -> (1, 256, h, w); the cell
    centres in f32 numpy, as the JAX ``dense_pe``."""
    h, w = size
    ys = (np.arange(h, dtype=np.float32) + 0.5) / h
    xs = (np.arange(w, dtype=np.float32) + 0.5) / w
    grid = np.stack(np.meshgrid(xs, ys), axis=-1)        # (h, w, 2) [x, y]
    dev = prompt.pe_layer.positional_encoding_gaussian_matrix.device
    pe = prompt.pe_layer.encode(torch.from_numpy(grid).to(dev))
    return pe.permute(2, 0, 1)[None]


def embed_points(prompt: PromptEncoder, coords, labels,
                 input_size: int = IMG_SIZE):
    """coords (B, N, 2) in the model input's pixels, labels (B, N) with 1
    positive, 0 negative, -1 pad -> (B, N + 1, 256): +0.5 to the pixel
    centres, and one pad point appended (the boxes-less path)."""
    b = coords.shape[0]
    coords = torch.cat([coords + 0.5, coords.new_zeros(b, 1, 2)], 1)
    labels = torch.cat([labels, -labels.new_ones(b, 1)], 1)
    emb = prompt.pe_layer.encode(coords / input_size)
    lab = labels[..., None]
    emb = torch.where(lab == -1, prompt.not_a_point_embed.weight[0], emb)
    emb = torch.where(lab == 0, emb + prompt.point_embeddings[0].weight[0],
                      emb)
    return torch.where(lab == 1, emb + prompt.point_embeddings[1].weight[0],
                       emb)


# ---------------------------------------------------------------------------
# two-way transformer and mask decoder
# ---------------------------------------------------------------------------

class DecoderAttention(nn.Module):
    """Attention with q / k / v / out projections, the inner width cut by
    ``down``; softmax(q k^T / sqrt(d)) v."""

    def __init__(self, down: int = 1):
        super().__init__()
        inner = PROMPT_DIM // down
        self.heads = DECODER_HEADS
        self.q_proj = nn.Linear(PROMPT_DIM, inner)
        self.k_proj = nn.Linear(PROMPT_DIM, inner)
        self.v_proj = nn.Linear(PROMPT_DIM, inner)
        self.out_proj = nn.Linear(inner, PROMPT_DIM)

    def forward(self, q, k, v):
        q, k, v = self.q_proj(q), self.k_proj(k), self.v_proj(v)
        b, nq, c = q.shape
        hd = c // self.heads

        def split(z):
            return z.reshape(b, z.shape[1], self.heads, hd).transpose(1, 2)

        a = split(q) @ split(k).transpose(2, 3) / math.sqrt(hd)
        o = (torch.softmax(a, -1) @ split(v)).transpose(1, 2)
        return self.out_proj(o.reshape(b, nq, c))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, skip_first_pe: bool):
        super().__init__()
        self.skip_first_pe = skip_first_pe
        self.self_attn = DecoderAttention()
        self.norm1 = nn.LayerNorm(PROMPT_DIM)
        self.cross_attn_token_to_image = DecoderAttention(down=2)
        self.norm2 = nn.LayerNorm(PROMPT_DIM)
        self.mlp = MLPBlock(PROMPT_DIM, 2048, act=F.relu)
        self.norm3 = nn.LayerNorm(PROMPT_DIM)
        self.norm4 = nn.LayerNorm(PROMPT_DIM)
        self.cross_attn_image_to_token = DecoderAttention(down=2)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)
        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(
            q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))
        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(
            k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self):
        super().__init__()
        self.layers = nn.ModuleList(
            [TwoWayAttentionBlock(i == 0) for i in range(2)])
        self.final_attn_token_to_image = DecoderAttention(down=2)
        self.norm_final_attn = nn.LayerNorm(PROMPT_DIM)

    def forward(self, keys, key_pe, tokens):
        queries = tokens
        for layer in self.layers:
            queries, keys = layer(queries, keys, tokens, key_pe)
        q, k = queries + tokens, keys + key_pe
        queries = self.norm_final_attn(
            queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys


class MLP(nn.Module):
    """Linear layers with ReLU between them (``layers.{i}``)."""

    def __init__(self, cin: int, hidden: int, cout: int, n: int = 3):
        super().__init__()
        dims = [cin] + [hidden] * (n - 1) + [cout]
        self.layers = nn.ModuleList(
            [nn.Linear(a, b) for a, b in zip(dims, dims[1:])])

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


def conv_transpose2(x, conv: nn.ConvTranspose2d):
    """A stride-2, 2x2 transposed conv as the JAX package computes it: one
    einsum over the (I, O, 2, 2) weight, then the bias."""
    b, _, h, w = x.shape
    y = torch.einsum("bihw,iokl->bohkwl", x, conv.weight)
    return y.reshape(b, -1, 2 * h, 2 * w) + conv.bias[:, None, None]


class MaskDecoder(nn.Module):
    """(image embedding (1, 256, h, w), its positional encoding (1, 256, h,
    w), sparse prompts (B, N, 256), the dense no-mask prompt (1, 256, 1, 1))
    -> (mask logits (B, M, 4 h, 4 w), predicted IoU (B, M)); M is 3 with
    ``multimask`` (the three multimask outputs), else 1."""

    def __init__(self):
        super().__init__()
        self.transformer = TwoWayTransformer()
        self.iou_token = nn.Embedding(1, PROMPT_DIM)
        self.mask_tokens = nn.Embedding(MASK_TOKENS, PROMPT_DIM)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(PROMPT_DIM, PROMPT_DIM // 4, 2, 2),
            LayerNorm2d(PROMPT_DIM // 4), nn.GELU(),
            nn.ConvTranspose2d(PROMPT_DIM // 4, PROMPT_DIM // 8, 2, 2),
            nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            [MLP(PROMPT_DIM, PROMPT_DIM, PROMPT_DIM // 8)
             for _ in range(MASK_TOKENS)])
        self.iou_prediction_head = MLP(PROMPT_DIM, PROMPT_DIM, MASK_TOKENS)

    def forward(self, image_emb, image_pe, sparse, dense,
                multimask: bool = True):
        b = sparse.shape[0]
        out_tokens = torch.cat([self.iou_token.weight,
                                self.mask_tokens.weight], 0)
        tokens = torch.cat([out_tokens[None].expand(b, -1, -1), sparse], 1)
        src = image_emb + dense
        _, c, h, w = src.shape
        keys = src.flatten(2).transpose(1, 2).expand(b, -1, -1)
        key_pe = image_pe.flatten(2).transpose(1, 2).expand(b, -1, -1)
        hs, keys = self.transformer(keys, key_pe, tokens)
        iou_tok, mask_toks = hs[:, 0], hs[:, 1:1 + MASK_TOKENS]

        up = self.output_upscaling
        src = keys.transpose(1, 2).reshape(b, c, h, w)
        x = F.gelu(up[1](conv_transpose2(src, up[0])))
        x = F.gelu(conv_transpose2(x, up[3]))             # (B, 32, 4h, 4w)
        hyper = torch.stack([mlp(mask_toks[:, i]) for i, mlp in
                             enumerate(self.output_hypernetworks_mlps)], 1)
        masks = torch.einsum("bmc,bchw->bmhw", hyper, x)
        iou = self.iou_prediction_head(iou_tok)
        if multimask:
            return masks[:, 1:], iou[:, 1:]
        return masks[:, :1], iou[:, :1]


# ---------------------------------------------------------------------------
# the model and its steps
# ---------------------------------------------------------------------------

class Sam(nn.Module):
    """The image encoder (ViT or TinyViT, by ``cfg.tiny``), the prompt
    encoder and the mask decoder under the published names."""

    def __init__(self, cfg: SamConfig = SAM_CONFIGS["vit_h"]):
        super().__init__()
        self.cfg = cfg
        if cfg.tiny:
            from pcdms_tpu_torch.pose.detectors.tiny_vit import TinyViT
            self.image_encoder = TinyViT()
        else:
            self.image_encoder = ImageEncoderViT(cfg)
        self.prompt_encoder = PromptEncoder()
        self.mask_decoder = MaskDecoder()

    def fold(self) -> "Sam":
        """TinyViT's BatchNorms folded into their convs (in place; a ViT
        encoder has none) -> self."""
        if self.cfg.tiny:
            self.image_encoder.fold()
        return self


def sam_encode_image(model: Sam, x):
    """x (B, 3, S, S): raw 0-255 RGB, already padded -> (B, 256, S / 16,
    S / 16). Normalised here, after the pad (the pad reads -mean / std)."""
    mean = torch.from_numpy(PIXEL_MEAN).to(x.device)[:, None, None]
    std = torch.from_numpy(PIXEL_STD).to(x.device)[:, None, None]
    return model.image_encoder((x - mean) / std)


def sam_predict_points(model: Sam, image_emb, coords, labels,
                       multimask: bool = True,
                       input_size: int = IMG_SIZE):
    """Batched point prompts: coords (B, N, 2) in the model input's pixels,
    labels (B, N) -> (low-res mask logits (B, M, 4 h, 4 w), IoU (B, M))."""
    prompt = model.prompt_encoder
    pe = dense_pe(prompt, tuple(image_emb.shape[2:]))
    sparse = embed_points(prompt, coords, labels, input_size=input_size)
    dense = prompt.no_mask_embed.weight.reshape(1, -1, 1, 1)
    return model.mask_decoder(image_emb, pe, sparse, dense,
                              multimask=multimask)


def load_sam(path: str) -> Sam:
    """A published SAM / MobileSAM file -> ``Sam`` on the CPU, in eval mode,
    its BatchNorms not folded; the configuration inferred from the keys
    (``sam_config``). The file is unpickled: read only trusted local
    files."""
    from pcdms_tpu_torch.compat.load import load_into
    from pcdms_tpu_torch.pose.detectors.common import (
        empty, load_torch_state_dict,
    )
    sd = load_torch_state_dict(path)
    model = empty(Sam, sam_config(sd))
    return load_into(model, {k: torch.from_numpy(v) for k, v in sd.items()},
                     path).eval()

