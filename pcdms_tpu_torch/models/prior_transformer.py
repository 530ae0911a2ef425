"""Stage-1 prior transformer (counterpart of
``pcdms_tpu/models/prior_transformer.py``), with the reference
``Stage1_PriorTransformer``'s state-dict names (the ones
``pcdms_tpu/compat/torch_convert.py::convert_prior`` reads).

It diffuses the target image's global CLIP embedding (1024-d) conditioned
on the source CLIP embedding and the source / target pose keypoints (36
floats each): a 20-layer, 32-head, d = 2048 pre-norm transformer over the
6-token sequence

    [src_pose, tgt_pose, ref_img_embed, time, noisy_embed, prd]

with learned positional embeddings, two 36 -> 512 -> 1024 pose MLPs
(Linear / GELU / LayerNorm / Linear / LayerNorm), GELU feed-forwards,
biased q / k / v projections and a final LayerNorm + 2048 -> 1024
projection read off the ``prd`` token. Six tokens take plain attention.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from pcdms_tpu_torch.nn.layers import (
    LayerNorm, Linear, TimestepEmbedding, gelu, timestep_sinusoidal_embedding,
)
from pcdms_tpu_torch.nn.transformer import BasicTransformerBlock

CLIP_MEAN = -0.016
CLIP_STD = 0.415


@dataclasses.dataclass(frozen=True)
class PriorConfig:
    num_heads: int = 32
    head_dim: int = 64
    num_layers: int = 20
    embedding_dim: int = 1024      # CLIP image embedding dim
    num_tokens: int = 6            # s_pose, t_pose, ref, time, noisy, prd
    pose_dim: int = 36             # 18 joints x (x, y)
    pose_hidden: int = 512
    use_flash: bool = False        # 6-token sequences: plain attention

    @property
    def inner_dim(self):
        return self.num_heads * self.head_dim


class PoseMLP(nn.Module):
    """The reference's Sequential(Linear, GELU, Dropout, LayerNorm, Linear,
    Dropout, LayerNorm): keys ``net.0``, ``net.3``, ``net.4``, ``net.6``."""

    def __init__(self, cfg: PriorConfig):
        super().__init__()
        self.net = nn.ModuleList([
            Linear(cfg.pose_dim, cfg.pose_hidden), nn.Identity(),
            nn.Identity(), LayerNorm(cfg.pose_hidden),
            Linear(cfg.pose_hidden, cfg.embedding_dim), nn.Identity(),
            LayerNorm(cfg.embedding_dim)])

    def forward(self, x):
        x = self.net[3](gelu(self.net[0](x)))
        return self.net[6](self.net[4](x))


class PriorTransformer(nn.Module):
    def __init__(self, cfg: PriorConfig = PriorConfig()):
        super().__init__()
        self.cfg = cfg
        d, e = cfg.inner_dim, cfg.embedding_dim
        self.pose_encoder = PoseMLP(cfg)
        self.pose_encoder1 = PoseMLP(cfg)
        self.time_embedding = TimestepEmbedding(d, d)
        self.proj_in = Linear(e, d)
        self.embedding_proj = Linear(e, d)
        self.encoder_hidden_states_proj = Linear(e, d)
        self.encoder_hidden_states_proj1 = Linear(e, d)
        self.positional_embedding = nn.Parameter(
            torch.zeros(1, cfg.num_tokens, d))
        self.prd_embedding = nn.Parameter(torch.zeros(1, 1, d))
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(d, cfg.num_heads, cfg.head_dim,
                                  qkv_bias=True, geglu=False)
            for _ in range(cfg.num_layers)])
        self.norm_out = LayerNorm(d)
        self.proj_to_clip_embeddings = Linear(d, e)

    def forward(self, noisy_embed, timesteps, proj_embedding, s_pose, t_pose,
                cfg_zero_cond: bool = False):
        """Predict the clean (normalised) target CLIP embedding.

        noisy_embed: (B, E) x_t; timesteps: (B,); proj_embedding: (B, E)
        source CLIP embedding; s_pose / t_pose: (B, 36) keypoints.
        cfg_zero_cond: the classifier-free-guidance path. The pose tokens
        are computed for the B // 2 rows of ``s_pose`` / ``t_pose`` and
        zeroed on the unconditional half put in front of them; the other
        inputs come doubled already."""
        dtype = noisy_embed.dtype
        b, d = noisy_embed.shape[0], self.cfg.inner_dim
        t_feat = timestep_sinusoidal_embedding(timesteps, d).to(dtype)
        time_token = self.time_embedding(t_feat)
        proj_token = self.embedding_proj(proj_embedding)
        s_tok = self.encoder_hidden_states_proj(self.pose_encoder(s_pose))
        t_tok = self.encoder_hidden_states_proj1(self.pose_encoder1(t_pose))
        if cfg_zero_cond:
            s_tok = torch.cat([torch.zeros_like(s_tok), s_tok])
            t_tok = torch.cat([torch.zeros_like(t_tok), t_tok])
        noisy_token = self.proj_in(noisy_embed)
        prd = self.prd_embedding.to(dtype).expand(b, 1, d)
        h = torch.stack([s_tok, t_tok, proj_token, time_token, noisy_token],
                        dim=1)
        h = torch.cat([h, prd], dim=1) + self.positional_embedding.to(dtype)
        for block in self.transformer_blocks:
            h = block(h, use_flash=self.cfg.use_flash)
        h = self.norm_out(h)
        return self.proj_to_clip_embeddings(h[:, -1])


def prior_post_process_latents(latents):
    """Un-normalise predicted embeddings by the dataset's CLIP stats."""
    return latents * CLIP_STD + CLIP_MEAN


def prior_normalize_embeds(embeds):
    """Normalise ground-truth CLIP embeddings (the training target)."""
    return (embeds - CLIP_MEAN) / CLIP_STD
