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
    """A conv whose bias may be absent or None (a bias-free conv)."""
    sd[f"{prefix}.weight"] = np.asarray(p["kernel"]).transpose(3, 2, 0, 1)
    if p.get("bias") is not None:
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


# ---------------------------------------------------------------------------
# the annotator networks (the inverses of the JAX ``convert_body`` /
# ``convert_hand`` / ``convert_face`` / ``convert_hed`` /
# ``convert_pidinet`` / ``convert_lineart``)
# ---------------------------------------------------------------------------

def _stack_sd(sd: StateDict, prefix: str, group) -> None:
    """{conv name: {kernel, bias}} -> ``prefix.name.weight / bias``."""
    for name, p in group.items():
        _conv(sd, f"{prefix}{name}", p)


def openpose_body_from_jax(p):
    """The JAX body tree (``convert_body``'s) -> the port's
    ``BodyPoseModel`` on the CPU, in eval mode."""
    from pcdms_tpu_torch.pose.detectors.openpose import BodyPoseModel
    sd: StateDict = {}
    for group, convs in p.items():
        _stack_sd(sd, f"{group}.", convs)
    return load_numpy_state_dict(BodyPoseModel(), sd).eval()


def openpose_hand_from_jax(p):
    """The JAX hand tree (``convert_hand``'s) -> ``HandPoseModel``."""
    from pcdms_tpu_torch.pose.detectors.openpose import HandPoseModel
    sd: StateDict = {}
    for group, convs in p.items():
        _stack_sd(sd, f"{group}.", convs)
    return load_numpy_state_dict(HandPoseModel(), sd).eval()


def openpose_face_from_jax(p):
    """The JAX face tree (``convert_face``'s: stem / head / stage2-6 groups
    of flat names) -> ``FaceNet``."""
    from pcdms_tpu_torch.pose.detectors.openpose import FaceNet
    sd: StateDict = {}
    for convs in p.values():
        _stack_sd(sd, "", convs)
    return load_numpy_state_dict(FaceNet(), sd).eval()


def hed_from_jax(p):
    """The JAX HED tree (``convert_hed``'s) -> ``ControlNetHED``."""
    from pcdms_tpu_torch.pose.detectors.hed import STAGES, ControlNetHED
    sd: StateDict = {"norm": np.asarray(p["norm"]).reshape(1, 3, 1, 1)}
    for si in range(1, len(STAGES) + 1):
        block = p[f"block{si}"]
        for i, c in enumerate(block["convs"]):
            _conv(sd, f"block{si}.convs.{i}", c)
        _conv(sd, f"block{si}.projection", block["proj"])
    return load_numpy_state_dict(ControlNetHED(), sd).eval()


def pidinet_from_jax(p):
    """The JAX PiDiNet tree (``convert_pidinet``'s, whose difference convs
    are already folded into plain kernels, which cannot be unfolded) ->
    (the port's ``PiDiNet`` with every other weight, {"init_block" / block
    name: the folded kernel, OIHW}) for ``PiDiNet.forward(x, kernels)``."""
    from pcdms_tpu_torch.pose.detectors.pidi import PiDiNet, _block_names

    def oihw(k):
        return torch.from_numpy(np.ascontiguousarray(
            np.asarray(k).transpose(3, 2, 0, 1)))
    model = PiDiNet()
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    kernels = {"init_block": oihw(p["init_block"]["kernel"])}
    names = iter(_block_names())
    for stage in range(4):
        for blk in p["blocks"][stage]:
            _, name, _, stride2 = next(names)
            kernels[name] = oihw(blk["conv1"]["kernel"])
            _conv(sd, f"{name}.conv2", blk["conv2"])
            if stride2:
                _conv(sd, f"{name}.shortcut", blk["shortcut"])
        _conv(sd, f"dilations.{stage}.conv1", p["cdcm"][stage]["conv1"])
        for i, d in enumerate(p["cdcm"][stage]["dilated"], start=1):
            _conv(sd, f"dilations.{stage}.conv2_{i}", d)
        for name in ("conv1", "conv2"):
            _conv(sd, f"attentions.{stage}.{name}", p["csam"][stage][name])
        _conv(sd, f"conv_reduces.{stage}.conv", p["reduce"][stage])
    _conv(sd, "classifier", p["classifier"])
    return load_numpy_state_dict(model, sd).eval(), kernels


def _conv_transpose(sd: StateDict, prefix: str, p) -> None:
    """``t2j_conv_transpose``'s flipped HWIO (I, O in torch's order) ->
    torch's (I, O, kH, kW)."""
    w = np.asarray(p["kernel"]).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
    sd[f"{prefix}.weight"] = np.ascontiguousarray(w)
    if p.get("bias") is not None:
        sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def lineart_from_jax(p):
    """The JAX LineArt tree (``convert_lineart``'s) -> ``Generator``."""
    from pcdms_tpu_torch.pose.detectors.lineart import Generator
    sd: StateDict = {}
    _conv(sd, "model0.1", p["stem"])
    _conv(sd, "model1.0", p["down"][0])
    _conv(sd, "model1.3", p["down"][1])
    for i, r in enumerate(p["res"]):
        _conv(sd, f"model2.{i}.conv_block.1", r["conv1"])
        _conv(sd, f"model2.{i}.conv_block.5", r["conv2"])
    _conv_transpose(sd, "model3.0", p["up"][0])
    _conv_transpose(sd, "model3.3", p["up"][1])
    _conv(sd, "model4.1", p["head"])
    return load_numpy_state_dict(Generator(), sd).eval()


def _unet_from_jax(p, model):
    """The JAX per-level U-Net list (outermost first) -> ``model``, a
    ``lineart_anime.UnetGenerator`` of as many levels."""
    sd: StateDict = {}
    prefix = "model.model."
    for i, level in enumerate(p):
        outermost, innermost = i == 0, i == len(p) - 1
        di = 0 if outermost else 1
        ui = 3 if (outermost or innermost) else 5
        _conv(sd, f"{prefix}{di}", level["down"])
        _conv_transpose(sd, f"{prefix}{ui}", level["up"])
        prefix += "1.model." if outermost else "3.model."
    return load_numpy_state_dict(model, sd).eval()


def lineart_anime_from_jax(p):
    """The JAX LineArt-Anime tree (``convert_lineart_anime``'s) ->
    ``lineart_anime.UnetGenerator``."""
    from pcdms_tpu_torch.pose.detectors.lineart_anime import UnetGenerator
    return _unet_from_jax(p, UnetGenerator())


def pix2pix_from_jax(p):
    """The JAX LeReS++ merge-network tree (``convert_pix2pix4depth``'s, any
    number of levels) -> ``leres_boost.pix2pix4depth``."""
    from pcdms_tpu_torch.pose.detectors.leres_boost import (
        LEVELS, pix2pix4depth,
    )
    return _unet_from_jax(p, pix2pix4depth(LEVELS[:len(p) - 1]
                                           + LEVELS[-1:]))


def mlsd_from_jax(p):
    """The JAX M-LSD tree (``convert_mlsd``'s: BatchNorm folded) -> the
    port's folded ``MobileV2_MLSD_Large``."""
    from pcdms_tpu_torch.pose.detectors.mlsd import (
        BLOCKS, MobileV2_MLSD_Large,
    )
    sd: StateDict = {}
    _conv(sd, "backbone.features.0.0", p["stem"])
    for i, ((t, _, _), blk) in enumerate(zip(BLOCKS, p["features"]), 1):
        pfx, j = f"backbone.features.{i}.conv", 0
        if t != 1:
            _conv(sd, f"{pfx}.0.0", blk["expand"])
            j = 1
        _conv(sd, f"{pfx}.{j}.0", blk["dw"])
        _conv(sd, f"{pfx}.{j + 1}", blk["project"])
    for n in range(15, 23):
        for c in ("conv1", "conv2"):
            _conv(sd, f"block{n}.{c}.0", p[f"block{n}"][c])
    for c in ("conv1", "conv2"):
        _conv(sd, f"block23.{c}.0", p["block23"][c])
    _conv(sd, "block23.conv3", p["block23"]["conv3"])
    return load_numpy_state_dict(MobileV2_MLSD_Large().fold(), sd).eval()


def _kernel(k):
    return {"kernel": k}


def _vit_blocks(sd: StateDict, prefix: str, blocks, beit: bool) -> None:
    for i, b in enumerate(blocks):
        pre = f"{prefix}.blocks.{i}"
        sd[f"{pre}.norm1.weight"] = np.asarray(b["ln1_scale"])
        sd[f"{pre}.norm1.bias"] = np.asarray(b["ln1_bias"])
        sd[f"{pre}.norm2.weight"] = np.asarray(b["ln2_scale"])
        sd[f"{pre}.norm2.bias"] = np.asarray(b["ln2_bias"])
        if beit:
            sd[f"{pre}.attn.qkv.weight"] = np.asarray(b["qkv_w"]).T
            sd[f"{pre}.attn.q_bias"] = np.asarray(b["q_bias"])
            sd[f"{pre}.attn.v_bias"] = np.asarray(b["v_bias"])
            sd[f"{pre}.attn.relative_position_bias_table"] = np.asarray(
                b["rel_pos_table"])
            sd[f"{pre}.gamma_1"] = np.asarray(b["gamma1"])
            sd[f"{pre}.gamma_2"] = np.asarray(b["gamma2"])
        else:
            _linear(sd, f"{pre}.attn.qkv", {"kernel": b["qkv_w"],
                                             "bias": b["qkv_b"]})
        for name, key in (("attn.proj", "proj"), ("mlp.fc1", "fc1"),
                          ("mlp.fc2", "fc2")):
            _linear(sd, f"{pre}.{name}", {"kernel": b[f"{key}_w"],
                                          "bias": b[f"{key}_b"]})


def _dpt_scratch(sd: StateDict, prefix: str, p) -> None:
    for i in range(1, 5):
        _conv(sd, f"{prefix}.layer{i}_rn", _kernel(p[f"layer{i}_rn"]))
        r = p[f"refinenet{i}"]
        for unit, key in (("resConfUnit1", "res1"), ("resConfUnit2", "res2")):
            for c in ("conv1", "conv2"):
                _conv(sd, f"{prefix}.refinenet{i}.{unit}.{c}", r[key][c])
        _conv(sd, f"{prefix}.refinenet{i}.out_conv", r["out_conv"])
    for c, idx in (("conv1", 0), ("conv2", 2), ("conv3", 4)):
        _conv(sd, f"{prefix}.output_conv.{idx}", p["head"][c])


def midas_from_jax(p):
    """The JAX DPT-Hybrid tree (``convert_dpt_hybrid``'s: the weight
    standardisation folded) -> the port's standardised ``DPTHybrid``."""
    from pcdms_tpu_torch.pose.detectors.midas import (
        DEPTHS, DPTHybrid, StdConv2dSame,
    )
    sd: StateDict = {}
    bb = "pretrained.model.patch_embed.backbone"
    res = p["resnet"]

    def gn(prefix, scale, bias):
        sd[f"{prefix}.weight"] = np.asarray(scale)
        sd[f"{prefix}.bias"] = np.asarray(bias)
    _conv(sd, f"{bb}.stem.conv", _kernel(res["stem"]["conv"]))
    gn(f"{bb}.stem.norm", res["stem"]["scale"], res["stem"]["bias"])
    for si, depth in enumerate(DEPTHS):
        for bi in range(depth):
            b, pre = res[f"stage{si}"][bi], f"{bb}.stages.{si}.blocks.{bi}"
            for i in (1, 2, 3):
                _conv(sd, f"{pre}.conv{i}", _kernel(b[f"conv{i}"]))
                gn(f"{pre}.norm{i}", b[f"norm{i}_scale"], b[f"norm{i}_bias"])
            if "downsample" in b:
                d = b["downsample"]
                _conv(sd, f"{pre}.downsample.conv", _kernel(d["conv"]))
                gn(f"{pre}.downsample.norm", d["scale"], d["bias"])
    pm = "pretrained.model"
    sd[f"{pm}.patch_embed.proj.weight"] = np.asarray(
        p["patch_proj_w"]).T[:, :, None, None]
    sd[f"{pm}.patch_embed.proj.bias"] = np.asarray(p["patch_proj_b"])
    sd[f"{pm}.cls_token"] = np.asarray(p["cls_token"])[None]
    sd[f"{pm}.pos_embed"] = np.asarray(p["pos_embed"])
    _vit_blocks(sd, pm, p["blocks"], beit=False)
    for i in (3, 4):
        r = p[f"readout{i}"]
        _linear(sd, f"pretrained.act_postprocess{i}.0.project.0",
                {"kernel": r["w"], "bias": r["b"]})
    _conv(sd, "pretrained.act_postprocess3.3", p["post3"])
    _conv(sd, "pretrained.act_postprocess4.3", p["post4a"])
    _conv(sd, "pretrained.act_postprocess4.4", p["post4b"])
    _dpt_scratch(sd, "scratch", p)
    model = DPTHybrid()
    for m in model.modules():
        if isinstance(m, StdConv2dSame):
            m.standardized = True
    return load_numpy_state_dict(model, sd).eval()


def normalbae_from_jax(p):
    """The JAX NNET tree (``convert_nnet``'s: BatchNorm folded) -> the
    port's folded ``NNET``."""
    from pcdms_tpu_torch.pose.detectors.normalbae import NNET, STAGES
    sd: StateDict = {}
    enc, e = "encoder.original_model", p["encoder"]
    _conv(sd, f"{enc}.conv_stem", e["stem"])
    _conv(sd, f"{enc}.conv_head", e["head"])
    for si, (_, _, x, _, reps) in enumerate(STAGES):
        for bi in range(reps):
            b, pre = e[f"stage{si}"][bi], f"{enc}.blocks.{si}.{bi}"
            names = (("dw", "conv_dw"), ("pwl", "conv_pw")) if x == 1 else (
                ("pw", "conv_pw"), ("dw", "conv_dw"), ("pwl", "conv_pwl"))
            for key, name in names:
                _conv(sd, f"{pre}.{name}", b[key])
            _conv(sd, f"{pre}.se.conv_reduce", b["se"]["reduce"])
            _conv(sd, f"{pre}.se.conv_expand", b["se"]["expand"])
    d = p["decoder"]
    _conv(sd, "decoder.conv2", d["conv2"])
    _conv(sd, "decoder.out_conv_res8", d["res8"])
    for i in range(1, 5):
        _conv(sd, f"decoder.up{i}._net.0", d[f"up{i}"]["conv1"])
        _conv(sd, f"decoder.up{i}._net.3", d[f"up{i}"]["conv2"])
    for r in ("res4", "res2", "res1"):
        for j, layer in zip((0, 2, 4, 6), d[r]):
            sd[f"decoder.out_conv_{r}.{j}.weight"] = np.asarray(
                layer["w"]).T[:, :, None]
            sd[f"decoder.out_conv_{r}.{j}.bias"] = np.asarray(layer["b"])
    return load_numpy_state_dict(NNET().fold(), sd).eval()


def zoe_from_jax(p):
    """The JAX ZoeDepth tree (``convert_zoedepth``'s) -> ``ZoeDepth``."""
    from pcdms_tpu_torch.pose.detectors.zoe import ZoeDepth
    sd: StateDict = {}
    core, beit = p["core"], p["core"]["beit"]
    pm, pp = "core.core.pretrained.model", "core.core.pretrained"
    _conv(sd, f"{pm}.patch_embed.proj", {"kernel": beit["patch_w"],
                                         "bias": beit["patch_b"]})
    sd[f"{pm}.cls_token"] = np.asarray(beit["cls_token"])[None]
    _vit_blocks(sd, pm, beit["blocks"], beit=True)
    for i in range(1, 5):
        post = core[f"post{i}"]
        r = post["readout"]
        _linear(sd, f"{pp}.act_postprocess{i}.0.project.0",
                {"kernel": r["w"], "bias": r["b"]})
        _conv(sd, f"{pp}.act_postprocess{i}.3", post["conv"])
        if "convt_w" in post:
            sd[f"{pp}.act_postprocess{i}.4.weight"] = np.asarray(
                post["convt_w"])
            sd[f"{pp}.act_postprocess{i}.4.bias"] = np.asarray(
                post["convt_b"])
        if "conv2" in post:
            _conv(sd, f"{pp}.act_postprocess{i}.4", post["conv2"])
    _dpt_scratch(sd, "core.core.scratch", core)
    z = p["zoe"]
    _conv(sd, "conv2", z["conv2"])

    def mlp2(prefix, q):
        _conv(sd, f"{prefix}.0", q["c1"])
        _conv(sd, f"{prefix}.2", q["c2"])
    mlp2("seed_bin_regressor._net", z["seed_bin_regressor"])
    mlp2("seed_projector._net", z["seed_projector"])
    for i in range(4):
        mlp2(f"projectors.{i}._net", z["projectors"][i])
        mlp2(f"attractors.{i}._net", z["attractors"][i])
    mlp2("conditional_log_binomial.mlp", z["clb"])
    return load_numpy_state_dict(ZoeDepth(), sd).eval()


def leres_from_jax(p):
    """The JAX LeReS tree (``convert_leres``'s: BatchNorm folded) -> the
    port's folded ``RelDepthModel``."""
    from pcdms_tpu_torch.pose.detectors.leres import LAYERS, RelDepthModel
    sd: StateDict = {}
    enc, e = "depth_model.encoder_modules", p["encoder"]
    _conv(sd, f"{enc}.conv1", e["stem"])
    for li, depth in enumerate(LAYERS, 1):
        for bi in range(depth):
            b, pre = e[f"layer{li}"][bi], f"{enc}.layer{li}.{bi}"
            for i in (1, 2, 3):
                _conv(sd, f"{pre}.conv{i}", b[f"conv{i}"])
            if "downsample" in b:
                _conv(sd, f"{pre}.downsample.0", b["downsample"])
    dec, d = "depth_model.decoder_modules", p["decoder"]

    def ftb(prefix, q):
        _conv(sd, f"{prefix}.conv1", q["conv1"])
        _conv(sd, f"{prefix}.conv_branch.1", q["branch1"])
        _conv(sd, f"{prefix}.conv_branch.4", q["branch2"])
    ftb(f"{dec}.conv", d["conv"])
    _conv(sd, f"{dec}.conv1", d["conv1"])
    for f in ("ffm2", "ffm1", "ffm0"):
        ftb(f"{dec}.{f}.ftb1", d[f]["ftb1"])
        ftb(f"{dec}.{f}.ftb2", d[f]["ftb2"])
    _conv(sd, f"{dec}.outconv.adapt_conv.0", d["ao1"])
    _conv(sd, f"{dec}.outconv.adapt_conv.3", d["ao2"])
    return load_numpy_state_dict(RelDepthModel().fold(), sd).eval()


def _sam_neck(sd: StateDict, prefix: str, p) -> None:
    _conv(sd, f"{prefix}.neck.0", _kernel(p["neck0_w"]))
    _conv(sd, f"{prefix}.neck.2", _kernel(p["neck1_w"]))
    for i, key in ((1, "neck_ln0"), (3, "neck_ln1")):
        sd[f"{prefix}.neck.{i}.weight"] = np.asarray(p[f"{key}_scale"])
        sd[f"{prefix}.neck.{i}.bias"] = np.asarray(p[f"{key}_bias"])


def _tiny_vit_sd(sd: StateDict, prefix: str, p) -> None:
    def cbn(name, q):
        _conv(sd, f"{prefix}.{name}.c", q)

    def lin(name, q, key):
        _linear(sd, f"{prefix}.{name}", {"kernel": q[f"{key}_w"],
                                         "bias": q[f"{key}_b"]})

    def norm(name, q):
        sd[f"{prefix}.{name}.weight"] = np.asarray(q["norm_scale"])
        sd[f"{prefix}.{name}.bias"] = np.asarray(q["norm_bias"])
    cbn("patch_embed.seq.0", p["patch_embed"][0])
    cbn("patch_embed.seq.2", p["patch_embed"][1])
    for si in range(4):
        for bi, b in enumerate(p[f"stage{si}"]):
            pre = f"layers.{si}.blocks.{bi}"
            if si == 0:
                for i in (1, 2, 3):
                    cbn(f"{pre}.conv{i}", b[f"conv{i}"])
                continue
            a, m = b["attn"], b["mlp"]
            norm(f"{pre}.attn.norm", a)
            lin(f"{pre}.attn.qkv", a, "qkv")
            lin(f"{pre}.attn.proj", a, "proj")
            sd[f"{prefix}.{pre}.attn.attention_biases"] = np.asarray(
                a["attention_biases"])
            cbn(f"{pre}.local_conv", b["local_conv"])
            norm(f"{pre}.mlp.norm", m)
            lin(f"{pre}.mlp.fc1", m, "fc1")
            lin(f"{pre}.mlp.fc2", m, "fc2")
        if si < 3:
            for i in (1, 2, 3):
                cbn(f"layers.{si}.downsample.conv{i}",
                    p[f"down{si}"][f"conv{i}"])
    _sam_neck(sd, prefix, p)


def tiny_vit_from_jax(p):
    """The JAX TinyViT tree (``convert_tiny_vit``'s: every Conv2d_BN folded,
    HWIO kernels, the linears stored (in, out)) -> the port's folded
    ``pose/detectors/tiny_vit.py::TinyViT``."""
    from pcdms_tpu_torch.pose.detectors.tiny_vit import TinyViT
    sd: StateDict = {}
    _tiny_vit_sd(sd, "image_encoder", p)
    return load_numpy_state_dict(TinyViT().fold(), {
        k.split(".", 1)[1]: v for k, v in sd.items()}).eval()


def _sam_attention(sd: StateDict, prefix: str, p) -> None:
    for a in ("q", "k", "v", "out"):
        _linear(sd, f"{prefix}.{a}_proj", {"kernel": p[f"{a}_w"],
                                           "bias": p[f"{a}_b"]})


def sam_from_jax(p, cfg=None):
    """The JAX SAM tree (``convert_sam``'s) -> the port's ``Sam`` (folded,
    for MobileSAM), its configuration ``cfg`` or, without one, read off the
    tree: vit_t for a TinyViT encoder, else the width, depth, head width
    (the tables' columns), global blocks (the tables sized by the grid, not
    the window) and input size (the position grid) of the ViT."""
    from pcdms_tpu_torch.pose.detectors.sam import (
        SAM_CONFIGS, WINDOW, Sam, SamConfig,
    )
    enc = p["encoder"]
    if cfg is None and "tiny" in enc:
        cfg = SAM_CONFIGS["vit_t"]
    elif cfg is None:
        blocks = enc["blocks"]
        dim = np.shape(enc["patch_w"])[-1]
        cfg = SamConfig(
            dim, len(blocks), dim // np.shape(blocks[0]["rel_pos_h"])[1],
            tuple(i for i, b in enumerate(blocks)
                  if np.shape(b["rel_pos_h"])[0] != 2 * WINDOW - 1),
            np.shape(enc["pos_embed"])[0] * 16)
    sd: StateDict = {}
    ie = "image_encoder"
    if cfg.tiny:
        _tiny_vit_sd(sd, ie, enc["tiny"])
    else:
        _conv(sd, f"{ie}.patch_embed.proj", {"kernel": enc["patch_w"],
                                             "bias": enc["patch_b"]})
        sd[f"{ie}.pos_embed"] = np.asarray(enc["pos_embed"])[None]
        for i, b in enumerate(enc["blocks"]):
            pre = f"{ie}.blocks.{i}"
            for n, key in (("norm1", "ln1"), ("norm2", "ln2")):
                sd[f"{pre}.{n}.weight"] = np.asarray(b[f"{key}_scale"])
                sd[f"{pre}.{n}.bias"] = np.asarray(b[f"{key}_bias"])
            for name, key in (("attn.qkv", "qkv"), ("attn.proj", "proj"),
                              ("mlp.lin1", "fc1"), ("mlp.lin2", "fc2")):
                _linear(sd, f"{pre}.{name}", {"kernel": b[f"{key}_w"],
                                              "bias": b[f"{key}_b"]})
            sd[f"{pre}.attn.rel_pos_h"] = np.asarray(b["rel_pos_h"])
            sd[f"{pre}.attn.rel_pos_w"] = np.asarray(b["rel_pos_w"])
        _sam_neck(sd, ie, enc)

    pr, pe = p["prompt"], "prompt_encoder"
    sd[f"{pe}.pe_layer.positional_encoding_gaussian_matrix"] = np.asarray(
        pr["pe_gauss"])
    for i, key in enumerate(("point_neg", "point_pos", "box_a", "box_b")):
        sd[f"{pe}.point_embeddings.{i}.weight"] = np.asarray(pr[key])[None]
    sd[f"{pe}.not_a_point_embed.weight"] = np.asarray(pr["not_a_point"])[None]

    d, md = p["decoder"], "mask_decoder"
    sd[f"{pe}.no_mask_embed.weight"] = np.asarray(d["no_mask"])[None]
    t, mt = d["transformer"], f"{md}.transformer"
    for i, layer in enumerate(t["layers"]):
        pre = f"{mt}.layers.{i}"
        for name, key in (("self_attn", "self_attn"),
                          ("cross_attn_token_to_image", "t2i"),
                          ("cross_attn_image_to_token", "i2t")):
            _sam_attention(sd, f"{pre}.{name}", layer[key])
        for j in (1, 2, 3, 4):
            sd[f"{pre}.norm{j}.weight"] = np.asarray(layer[f"ln{j}_scale"])
            sd[f"{pre}.norm{j}.bias"] = np.asarray(layer[f"ln{j}_bias"])
        for name, key in (("mlp.lin1", "fc1"), ("mlp.lin2", "fc2")):
            _linear(sd, f"{pre}.{name}", {"kernel": layer[f"{key}_w"],
                                          "bias": layer[f"{key}_b"]})
    _sam_attention(sd, f"{mt}.final_attn_token_to_image", t["final_attn"])
    sd[f"{mt}.norm_final_attn.weight"] = np.asarray(t["final_ln_scale"])
    sd[f"{mt}.norm_final_attn.bias"] = np.asarray(t["final_ln_bias"])
    sd[f"{md}.iou_token.weight"] = np.asarray(d["iou_token"])
    sd[f"{md}.mask_tokens.weight"] = np.asarray(d["mask_tokens"])
    for i, key in ((0, "up0"), (3, "up1")):
        sd[f"{md}.output_upscaling.{i}.weight"] = np.asarray(d[f"{key}_w"])
        sd[f"{md}.output_upscaling.{i}.bias"] = np.asarray(d[f"{key}_b"])
    sd[f"{md}.output_upscaling.1.weight"] = np.asarray(d["up_ln_scale"])
    sd[f"{md}.output_upscaling.1.bias"] = np.asarray(d["up_ln_bias"])
    for name, mlps in ((f"{md}.output_hypernetworks_mlps.{i}", m)
                       for i, m in enumerate(d["hyper_mlps"])):
        for j, layer in enumerate(mlps):
            _linear(sd, f"{name}.layers.{j}", {"kernel": layer["w"],
                                               "bias": layer["b"]})
    for j, layer in enumerate(d["iou_head"]):
        _linear(sd, f"{md}.iou_prediction_head.layers.{j}",
                {"kernel": layer["w"], "bias": layer["b"]})
    return load_numpy_state_dict(Sam(cfg).fold(), sd).eval()
