"""JAX parameter pytrees -> the port's modules.

The inverse of ``pcdms_tpu/compat/torch_convert.py`` (and of the DWPose
networks' ``convert_yolox`` / ``convert_rtmpose``): turns the JAX
package's parameter pytrees (leaves as numpy arrays) into diffusers-named
state dicts for ``UNet2DConditionModel``, ``AutoencoderKL``,
``ImageProjModel``, ``PoseCondEmbedding``, ``PriorTransformer`` (the
reference prior's names) and the ``VisionTransformer`` encoders
(HuggingFace names):

  * Linear kernel (in, out) -> weight (out, in)
  * Conv kernel HWIO        -> weight OIHW
  * Norm scale / bias       -> weight / bias

So one set of weights drives both packages.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

StateDict = Dict[str, np.ndarray]


def _linear(sd: StateDict, prefix: str, p) -> None:
    sd[f"{prefix}.weight"] = np.asarray(p["kernel"]).T
    if "bias" in p:
        sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def _conv(sd: StateDict, prefix: str, p) -> None:
    sd[f"{prefix}.weight"] = np.asarray(p["kernel"]).transpose(3, 2, 0, 1)
    if "bias" in p:
        sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def _norm(sd: StateDict, prefix: str, p) -> None:
    sd[f"{prefix}.weight"] = np.asarray(p["scale"])
    sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def _timestep_embedding(sd, prefix, p):
    _linear(sd, f"{prefix}.linear_1", p["linear_1"])
    _linear(sd, f"{prefix}.linear_2", p["linear_2"])
    if "cond_proj" in p:
        _linear(sd, f"{prefix}.cond_proj", p["cond_proj"])


def _resnet(sd, prefix, p):
    _norm(sd, f"{prefix}.norm1", p["norm1"])
    _conv(sd, f"{prefix}.conv1", p["conv1"])
    _norm(sd, f"{prefix}.norm2", p["norm2"])
    _conv(sd, f"{prefix}.conv2", p["conv2"])
    if "time_emb_proj" in p:
        _linear(sd, f"{prefix}.time_emb_proj", p["time_emb_proj"])
    if "conv_shortcut" in p:
        _conv(sd, f"{prefix}.conv_shortcut", p["conv_shortcut"])


def _attention(sd, prefix, p):
    for name in ("to_q", "to_k", "to_v"):
        _linear(sd, f"{prefix}.{name}", p[name])
    _linear(sd, f"{prefix}.to_out.0", p["to_out"])


def _transformer_block(sd, prefix, p):
    _norm(sd, f"{prefix}.norm1", p["norm1"])
    _attention(sd, f"{prefix}.attn1", p["attn1"])
    if "attn2" in p:
        _norm(sd, f"{prefix}.norm2", p["norm2"])
        _attention(sd, f"{prefix}.attn2", p["attn2"])
    _norm(sd, f"{prefix}.norm3", p["norm3"])
    _linear(sd, f"{prefix}.ff.net.0.proj", p["ff"]["proj_in"])
    _linear(sd, f"{prefix}.ff.net.2", p["ff"]["proj_out"])


def _transformer2d(sd, prefix, p):
    _norm(sd, f"{prefix}.norm", p["norm"])
    _linear(sd, f"{prefix}.proj_in", p["proj_in"])
    for i, block in enumerate(p["blocks"]):
        _transformer_block(sd, f"{prefix}.transformer_blocks.{i}", block)
    _linear(sd, f"{prefix}.proj_out", p["proj_out"])


def _unet_block(sd, prefix, p, sampler):
    for j, r in enumerate(p["resnets"]):
        _resnet(sd, f"{prefix}.resnets.{j}", r)
    for j, a in enumerate(p.get("attentions", ())):
        _transformer2d(sd, f"{prefix}.attentions.{j}", a)
    if sampler in p:
        _conv(sd, f"{prefix}.{sampler}s.0.conv", p[sampler]["conv"])


def unet_state_dict(p) -> StateDict:
    """``unet_init`` pytree -> ``UNet2DConditionModel`` state dict."""
    sd: StateDict = {}
    _timestep_embedding(sd, "time_embedding", p["time_embedding"])
    if "class_embedding" in p:
        _timestep_embedding(sd, "class_embedding", p["class_embedding"])
    _conv(sd, "conv_in", p["conv_in"])
    for i, block in enumerate(p["down_blocks"]):
        _unet_block(sd, f"down_blocks.{i}", block, "downsampler")
    mid = p["mid_block"]
    _resnet(sd, "mid_block.resnets.0", mid["resnet1"])
    _transformer2d(sd, "mid_block.attentions.0", mid["attention"])
    _resnet(sd, "mid_block.resnets.1", mid["resnet2"])
    for i, block in enumerate(p["up_blocks"]):
        _unet_block(sd, f"up_blocks.{i}", block, "upsampler")
    _norm(sd, "conv_norm_out", p["conv_norm_out"])
    _conv(sd, "conv_out", p["conv_out"])
    return sd


def _vae_mid(sd, prefix, p):
    _resnet(sd, f"{prefix}.resnets.0", p["resnet1"])
    attn = p["attention"]
    _norm(sd, f"{prefix}.attentions.0.group_norm", attn["norm"])
    _attention(sd, f"{prefix}.attentions.0", attn)
    _resnet(sd, f"{prefix}.resnets.1", p["resnet2"])


def vae_state_dict(p) -> StateDict:
    """``vae_init`` pytree -> ``AutoencoderKL`` state dict."""
    sd: StateDict = {}
    enc, dec = p["encoder"], p["decoder"]
    _conv(sd, "encoder.conv_in", enc["conv_in"])
    for i, block in enumerate(enc["down_blocks"]):
        for j, r in enumerate(block["resnets"]):
            _resnet(sd, f"encoder.down_blocks.{i}.resnets.{j}", r)
        if "downsampler" in block:
            _conv(sd, f"encoder.down_blocks.{i}.downsamplers.0.conv",
                  block["downsampler"])
    _vae_mid(sd, "encoder.mid_block", enc["mid"])
    _norm(sd, "encoder.conv_norm_out", enc["norm_out"])
    _conv(sd, "encoder.conv_out", enc["conv_out"])
    _conv(sd, "decoder.conv_in", dec["conv_in"])
    _vae_mid(sd, "decoder.mid_block", dec["mid"])
    for i, block in enumerate(dec["up_blocks"]):
        for j, r in enumerate(block["resnets"]):
            _resnet(sd, f"decoder.up_blocks.{i}.resnets.{j}", r)
        if "upsampler" in block:
            _conv(sd, f"decoder.up_blocks.{i}.upsamplers.0.conv",
                  block["upsampler"])
    _norm(sd, "decoder.conv_norm_out", dec["norm_out"])
    _conv(sd, "decoder.conv_out", dec["conv_out"])
    _conv(sd, "quant_conv", p["quant_conv"])
    _conv(sd, "post_quant_conv", p["post_quant_conv"])
    return sd


def image_proj_state_dict(p) -> StateDict:
    """``image_proj_mlp_init`` pytree -> ``ImageProjModel`` state dict."""
    sd: StateDict = {}
    _linear(sd, "net.0", p["fc1"])
    _norm(sd, "net.3", p["norm"])
    _linear(sd, "net.4", p["fc2"])
    return sd


def pose_proj_state_dict(p) -> StateDict:
    """``pose_cond_embedding_init`` pytree -> ``PoseCondEmbedding`` state
    dict."""
    sd: StateDict = {}
    _conv(sd, "conv_in", p["conv_in"])
    for i, block in enumerate(p["blocks"]):
        _conv(sd, f"blocks.{i}", block)
    _conv(sd, "conv_out", p["conv_out"])
    return sd


def prior_state_dict(p) -> StateDict:
    """``prior_init`` pytree -> ``PriorTransformer`` state dict."""
    sd: StateDict = {}
    for name in ("pose_encoder", "pose_encoder1"):
        mlp = p[name]
        _linear(sd, f"{name}.net.0", mlp["fc1"])
        _norm(sd, f"{name}.net.3", mlp["norm1"])
        _linear(sd, f"{name}.net.4", mlp["fc2"])
        _norm(sd, f"{name}.net.6", mlp["norm2"])
    _timestep_embedding(sd, "time_embedding", p["time_embedding"])
    for name in ("proj_in", "embedding_proj", "encoder_hidden_states_proj",
                 "encoder_hidden_states_proj1", "proj_to_clip_embeddings"):
        _linear(sd, name, p[name])
    for name in ("positional_embedding", "prd_embedding"):
        sd[name] = np.asarray(p[name])
    for i, block in enumerate(p["blocks"]):
        _transformer_block(sd, f"transformer_blocks.{i}", block)
    _norm(sd, "norm_out", p["norm_out"])
    return sd


def _vit_layer(sd, prefix, p, clip: bool):
    if clip:      # CLIPEncoderLayer
        _norm(sd, f"{prefix}.layer_norm1", p["norm1"])
        for jax_name, name in (("to_q", "q_proj"), ("to_k", "k_proj"),
                               ("to_v", "v_proj"), ("to_out", "out_proj")):
            _linear(sd, f"{prefix}.self_attn.{name}", p["attn"][jax_name])
        _norm(sd, f"{prefix}.layer_norm2", p["norm2"])
    else:         # Dinov2Layer
        _norm(sd, f"{prefix}.norm1", p["norm1"])
        for jax_name, name in (("to_q", "attention.query"),
                               ("to_k", "attention.key"),
                               ("to_v", "attention.value"),
                               ("to_out", "output.dense")):
            _linear(sd, f"{prefix}.attention.{name}", p["attn"][jax_name])
        _norm(sd, f"{prefix}.norm2", p["norm2"])
    for i in (1, 2):
        if f"ls{i}" in p:
            sd[f"{prefix}.layer_scale{i}.lambda1"] = np.asarray(p[f"ls{i}"])
    for name, sub in p["mlp"].items():
        _linear(sd, f"{prefix}.mlp.{name}", sub)


def vit_state_dict(p, cfg) -> StateDict:
    """``vit_init`` pytree -> ``VisionTransformer`` state dict: HF
    ``CLIPVisionModelWithProjection`` names when ``cfg.pre_layernorm``,
    ``Dinov2Model`` names otherwise."""
    sd: StateDict = {}
    patch = p["patch_embed"]
    if cfg.pre_layernorm:
        pre = "vision_model"
        sd[f"{pre}.embeddings.class_embedding"] = np.asarray(
            p["cls_token"]).reshape(-1)
        _conv(sd, f"{pre}.embeddings.patch_embedding", patch)
        sd[f"{pre}.embeddings.position_embedding.weight"] = np.asarray(
            p["pos_embed"])[0]
        _norm(sd, f"{pre}.pre_layrnorm", p["pre_norm"])
        for i, layer in enumerate(p["layers"]):
            _vit_layer(sd, f"{pre}.encoder.layers.{i}", layer, clip=True)
        _norm(sd, f"{pre}.post_layernorm", p["final_norm"])
        if "projection" in p:
            _linear(sd, "visual_projection", p["projection"])
    else:
        sd["embeddings.cls_token"] = np.asarray(p["cls_token"])
        _conv(sd, "embeddings.patch_embeddings.projection", patch)
        sd["embeddings.position_embeddings"] = np.asarray(p["pos_embed"])
        for i, layer in enumerate(p["layers"]):
            _vit_layer(sd, f"encoder.layer.{i}", layer, clip=False)
        _norm(sd, "layernorm", p["final_norm"])
    return sd


def load_numpy_state_dict(module: torch.nn.Module, sd: StateDict):
    """Load a numpy state dict into ``module`` (every key must match) in
    the module's own dtype and device; returns the module."""
    ref = next(module.parameters())
    module.load_state_dict({
        k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(
            device=ref.device, dtype=ref.dtype)
        for k, v in sd.items()}, strict=True)
    return module


def inception_from_jax(p):
    """The JAX FID InceptionV3 tree (``convert_inception``'s: folded-BN
    HWIO kernels and biases per unit, blocks as {branch: unit}) -> the
    port's ``eval/inception.py::InceptionV3`` on the CPU, in eval mode."""
    from pcdms_tpu_torch.eval.inception import UNITS, InceptionV3
    sd: StateDict = {}
    for prefix in UNITS:
        block, _, branch = prefix.partition(".")
        _conv(sd, prefix, p[block][branch] if branch else p[block])
    return load_numpy_state_dict(InceptionV3(), sd).eval()


def lpips_from_jax(p):
    """The JAX LPIPS tree (``convert_lpips``'s: ``net``, five HWIO convs;
    ``lins``, five (C,) heads) -> the port's ``eval/lpips.py::LPIPS`` on
    the CPU, in eval mode."""
    from pcdms_tpu_torch.eval.lpips import LPIPS
    sd: StateDict = {}
    for i, (conv, lin) in enumerate(zip(p["net"], p["lins"])):
        _conv(sd, f"convs.{i}", conv)
        sd[f"lins.{i}"] = np.asarray(lin)
    return load_numpy_state_dict(LPIPS(), sd).eval()


def _yolox_csp(sd, prefix, p):
    for name in ("main_conv", "short_conv", "final_conv"):
        _conv(sd, f"{prefix}.{name}.conv", p[name])
    for i, blk in enumerate(p["blocks"]):
        _conv(sd, f"{prefix}.blocks.{i}.conv1.conv", blk["conv1"])
        _conv(sd, f"{prefix}.blocks.{i}.conv2.conv", blk["conv2"])


def _cspnext_csp(sd, prefix, p):
    for name in ("main_conv", "short_conv", "final_conv"):
        _conv(sd, f"{prefix}.{name}.conv", p[name])
    _conv(sd, f"{prefix}.attention.fc", p["attention"])
    for i, blk in enumerate(p["blocks"]):
        _conv(sd, f"{prefix}.blocks.{i}.conv1.conv", blk["conv1"])
        # depthwise HWIO (5, 5, 1, C) -> (C, 1, 5, 5)
        _conv(sd, f"{prefix}.blocks.{i}.conv2.depthwise_conv.conv",
              blk["conv2_dw"])
        _conv(sd, f"{prefix}.blocks.{i}.conv2.pointwise_conv.conv",
              blk["conv2_pw"])


def _mm_stages(sd, p, arch, csp):
    """The stride-2 conv, SPP and CSP layer of each backbone stage."""
    for si, (*_, use_spp) in enumerate(arch, 1):
        stage = p[f"stage{si}"]
        _conv(sd, f"backbone.stage{si}.0.conv", stage["conv"])
        if use_spp:
            for name in ("conv1", "conv2"):
                _conv(sd, f"backbone.stage{si}.1.{name}.conv",
                      stage["spp"][name])
        csp(sd, f"backbone.stage{si}.{2 if use_spp else 1}", stage["csp"])


def yolox_from_jax(p):
    """The JAX YOLOX-l tree (``convert_yolox``'s: BatchNorm folded, HWIO
    kernels and biases) -> the port's folded ``pose/detectors/yolox.py::
    YOLOX`` on the CPU, in eval mode."""
    from pcdms_tpu_torch.pose.detectors.common import fold_bn
    from pcdms_tpu_torch.pose.detectors.yolox import DARKNET_ARCH, YOLOX
    sd: StateDict = {}
    _conv(sd, "backbone.stem.conv.conv", p["backbone"]["stem"])
    _mm_stages(sd, p["backbone"], DARKNET_ARCH, _yolox_csp)
    neck = p["neck"]
    for i in range(2):
        _conv(sd, f"neck.reduce_layers.{i}.conv", neck[f"reduce{i}"])
        _yolox_csp(sd, f"neck.top_down_blocks.{i}", neck[f"top_down{i}"])
        _conv(sd, f"neck.downsamples.{i}.conv", neck[f"down{i}"])
        _yolox_csp(sd, f"neck.bottom_up_blocks.{i}", neck[f"bottom_up{i}"])
    for i in range(3):
        _conv(sd, f"neck.out_convs.{i}.conv", neck[f"out{i}"])
    for lvl in range(3):
        lp = p["head"][f"lvl{lvl}"]
        for kind in ("cls", "reg"):
            for i, c in enumerate(lp[f"{kind}_convs"]):
                _conv(sd, f"bbox_head.multi_level_{kind}_convs.{lvl}.{i}.conv",
                      c)
        for kind in ("cls", "reg", "obj"):
            _conv(sd, f"bbox_head.multi_level_conv_{kind}.{lvl}",
                  lp[f"conv_{kind}"])
    return load_numpy_state_dict(fold_bn(YOLOX()), sd).eval()


def rtmpose_from_jax(p):
    """The JAX RTMPose-l tree (``convert_rtmpose``'s: BatchNorm folded, HWIO
    kernels, the linears stored (in, out)) -> the port's folded
    ``pose/detectors/rtmpose.py::RTMPose`` on the CPU, in eval mode."""
    from pcdms_tpu_torch.pose.detectors.common import fold_bn
    from pcdms_tpu_torch.pose.detectors.rtmpose import CSPNEXT_ARCH, RTMPose
    sd: StateDict = {}
    for i, c in enumerate(p["backbone"]["stem"]):
        _conv(sd, f"backbone.stem.{i}.conv", c)
    _mm_stages(sd, p["backbone"], CSPNEXT_ARCH, _cspnext_csp)
    head, gau = p["head"], p["head"]["gau"]
    _conv(sd, "head.final_layer", head["final_layer"])
    sd["head.mlp.0.g"] = np.asarray(head["mlp_norm_g"]).reshape(1)
    sd["head.mlp.1.weight"] = np.asarray(head["mlp"]).T
    sd["head.gau.ln.g"] = np.asarray(gau["ln_g"]).reshape(1)
    for name in ("uv", "o"):
        sd[f"head.gau.{name}.weight"] = np.asarray(gau[name]).T
    for name in ("gamma", "beta"):
        sd[f"head.gau.{name}"] = np.asarray(gau[name])
    sd["head.gau.res_scale.scale"] = np.asarray(gau["res_scale"])
    for name in ("cls_x", "cls_y"):
        sd[f"head.{name}.weight"] = np.asarray(head[name]).T
    return load_numpy_state_dict(fold_bn(RTMPose()), sd).eval()
