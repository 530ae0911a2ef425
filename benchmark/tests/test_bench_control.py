"""The comparison that decides ``correct`` fails what it should, at tiny
sizes on the CPU, past the harness's look for a card: the control (the
reference in float8 e4m3 in the program's place; for the trainer, the
program's linear layers and convolutions rounding their operands to
float8) and each fault the cells can have (an answer altered where it is
produced, a sampler step or an optimizer step that returns its state
unchanged, half of the batch left out), each under the cell's own limits;
and a sound run passes them."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark import harness
from benchmark.reference import nets as ref_nets
from benchmark.reference import sampling as ref_sampling
from benchmark.tests import tiny

SAMPLERS = ["s2-sample-b8-unipc20", "s3-sample-b16-unipc20",
            "s2-serve-poisson"]
CELLS = SAMPLERS + ["s2-train-b8"]
SEED = 2**31 + 77


def _limits(cell):
    return {k: v["limit"] for k, v in harness.load_cell(cell).limits.items()}


def _patch_generate(monkeypatch, wrap):
    """Route the program's stage-2 / stage-3 entries through ``wrap``."""
    from pcdms_tpu_torch.pipelines import stage2_inpaint, stage3_refine
    from pcdms_tpu_torch.serve import stage2 as serve_stage2
    for mod, name in ((stage2_inpaint, "stage2_generate"),
                      (serve_stage2, "stage2_generate"),
                      (stage3_refine, "stage3_generate")):
        monkeypatch.setattr(mod, name, wrap(getattr(mod, name)))


def _altered(fn):
    def run(*a, **k):
        out = fn(*a, **k).clone()
        out[:, :, out.shape[2] // 2:] *= -1.0
        return out
    return run


def _half_batch(fn):
    def run(models, *inputs, latents=None, **k):
        n = latents.shape[0]
        h = max(1, n // 2)
        out = fn(models, *[None if x is None else x[:h] for x in inputs],
                 latents=latents[:h], **k)
        return torch.cat([out, out[-1:].expand(n - h, *out.shape[1:])])
    return run


def _control(cell_name):
    """The fp8 reference computing every row in the program's place."""
    cfg = tiny.tiny_cell(cell_name).config

    def wrap(fn):
        def run(models, *inputs, latents=None, num_steps=20,
                guidance_scale=2.0, **k):
            dev = latents.device if torch.is_tensor(latents) else "cpu"
            with torch.device("meta"):
                nets = {n: ref_nets.NETS[n](cfg[n]) for n in models}
            from benchmark import weights
            for i, (n, m) in enumerate(nets.items()):
                drawn = weights.draw(weights.specs(m),
                                     weights.derive_seed(SEED, i), dev,
                                     torch.bfloat16)
                weights.install(m, {a: t.float() for a, t in drawn.items()})
                ref_nets.set_precision(m, "fp8")
            lat = torch.as_tensor(np.asarray(latents)).float()
            outs = []
            for i in range(lat.shape[0]):
                t = [torch.as_tensor(np.asarray(x[i:i + 1])).float()
                     for x in inputs]
                if fn.__name__ == "stage2_generate":
                    row = {"vae_image": t[0], "st_pose": t[1], "dino": t[2],
                           "embed": t[3]}
                    outs.append(ref_sampling.stage2_one(
                        nets, row, lat[i:i + 1], num_steps, guidance_scale))
                else:
                    row = {"gen_image": t[0], "dino": t[1]}
                    outs.append(ref_sampling.stage3_one(
                        nets, row, lat[i:i + 1], num_steps, guidance_scale))
            return torch.cat(outs)
        run.__name__ = fn.__name__
        return run
    return wrap


def _unchanged_step(monkeypatch):
    from pcdms_tpu_torch.diffusion import unipc
    monkeypatch.setattr(unipc, "_predictor", lambda x, *a, **k: x)


def _fp8_layers(monkeypatch):
    """The program's linear layers and convolutions on float8 operands."""
    from pcdms_tpu_torch.nn import layers

    def q(t):
        return None if t is None else ref_nets.fp8_round(t).to(t.dtype)

    monkeypatch.setattr(layers.Linear, "forward", lambda self, x: F.linear(
        q(x), q(self.weight.to(x.dtype)), layers._as(self.bias, x)))
    monkeypatch.setattr(layers.Conv2d, "forward",
                        lambda self, x: self._conv_forward(
                            q(x), q(self.weight.to(x.dtype)),
                            layers._as(self.bias, x)))


def _half_loss(monkeypatch):
    """The trainer's loss over the first half of each batch only."""
    from pcdms_tpu_torch.train import stage2
    loss = stage2.stage2_loss

    def half(models, vae, batch, draws, **kw):
        n = batch["st_image"].shape[0] // 2
        return loss(models, vae, {k: v[:n] for k, v in batch.items()},
                    {k: v[:n] for k, v in draws.items()}, **kw)

    monkeypatch.setattr(stage2, "stage2_loss", half)


def _frozen_optimizer(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step",
                        lambda self, *a, **k: None)


def _run(cell, compute_dtype=None):
    return tiny.run_tiny(cell, seed=SEED, limits=_limits(cell),
                         compute_dtype=compute_dtype)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    """The samplers in their bfloat16; the trainer in float32, since at the
    tiny widths a bfloat16 leaf of a few dozen values reads its gradient
    tens of percent off (0.39 here, 0.004-0.015 at the published widths)."""
    r = _run(cell, "float32" if cell == "s2-train-b8" else None)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("cell", SAMPLERS)
@pytest.mark.parametrize("fault", ["control", "altered", "unchanged_step",
                                   "half_batch"])
def test_sampler_fault_is_not_correct(cell, fault, monkeypatch):
    if fault == "control":
        _patch_generate(monkeypatch, _control(cell))
    elif fault == "altered":
        _patch_generate(monkeypatch, _altered)
    elif fault == "half_batch":
        _patch_generate(monkeypatch, _half_batch)
    else:
        _unchanged_step(monkeypatch)
    r = _run(cell)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", ["control", "unchanged_state",
                                   "half_batch"])
def test_trainer_fault_is_not_correct(fault, monkeypatch):
    {"control": _fp8_layers, "unchanged_state": _frozen_optimizer,
     "half_batch": _half_loss}[fault](monkeypatch)
    r = _run("s2-train-b8")
    assert not r["correct"], r["checks"]
