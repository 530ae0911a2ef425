"""Tiny stand-ins for the benchmark's configurations and traffic, for CPU
tests that drive a whole run without the card (the geometry of
``pcdms_tpu_torch/cli/common.py::tiny_configs``)."""

from __future__ import annotations

import copy
import time

import torch

from benchmark import harness

UNET = {"out_channels": 4, "block_out_channels": [8, 16, 16, 16],
        "layers_per_block": 1, "cross_attention_dim": 16,
        "attention_head_dim": 8, "cross_attn_down": [True, True, True, False],
        "norm_groups": 4}
VAE = {"in_channels": 3, "latent_channels": 4,
       "block_out_channels": [4, 8, 8, 8], "layers_per_block": 1,
       "norm_groups": 2, "scaling_factor": 0.18215}


def tiny_config(cfg: dict) -> dict:
    out = copy.deepcopy(cfg)
    out["unet"] = dict(UNET, in_channels=cfg["unet"]["in_channels"],
                       class_embed_proj_dim=(16 if cfg["unet"][
                           "class_embed_proj_dim"] else None))
    out["vae"] = dict(VAE)
    out["image_proj"] = {"in_dim": 24, "hidden_dim": 16, "out_dim": 16}
    out["dino_tokens"], out["dino_dim"] = 5, 24
    if "pose_proj" in cfg:
        out["pose_proj"] = {"out_channels": 8,
                            "block_out_channels": [4, 4, 4, 4]}
        out["embed_dim"] = 16
        out["canvas"] = [64, 128]
    else:
        out["canvas"] = [64, 64]
    return out


TINY_PARAMS = {"batch": 2, "num_steps": 3, "distinct_batches": 3,
               "check_rows": 2, "trace_batches": 1, "rate": 20.0,
               "buckets": [2], "check_steps": 3,
               "trace_steps": 1}


def tiny_cell(name: str, limits: dict = None,
              compute_dtype: str = None) -> harness.Cell:
    cell = harness.load_cell(name)
    cell.config = tiny_config(cell.config)
    if compute_dtype is not None:
        cell.config["compute_dtype"] = compute_dtype
    cell.traffic = copy.deepcopy(cell.traffic)
    p = cell.traffic["params"]
    p.update({k: v for k, v in TINY_PARAMS.items() if k in p})
    if limits is not None:
        cell.limits = {k: {"limit": v} for k, v in limits.items()}
    return cell


def run_tiny(name: str, seed: int = 2**31 + 5, seconds: float = 0.2,
             limits: dict = None, compute_dtype: str = None) -> dict:
    """A whole run of the cell at tiny size on the CPU, past the look for a
    card."""
    return harness.run_cell(tiny_cell(name, limits, compute_dtype), seed, seconds, False,
                            torch.device("cpu"), time.perf_counter(),
                            log=lambda *a, **k: None)
