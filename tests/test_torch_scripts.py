"""The port's counterparts of ``examples/serve_client.py``,
``scripts/fastpath_drift.py`` and the ``scripts/run_*.sh`` launchers, on
the CPU at the tiny configurations.

* ``cli/serve_client.py`` against ``pcdms-torch-serve``'s deployment
  (``cli/serve.py::build_deployment``, tiny, random, on the CPU) behind
  ``ServingServer`` in this process: one request round trip, the PNG
  written; its requests equal the JAX client's for the same seed and files.
* ``cli/fastpath_drift.py``: ``psnr`` within 1e-5 dB of the JAX script's
  (an f32 mean there, f64 here), ``cosine`` equal;
  the table (UniPC 20, DDIM 20, encoder propagation at intervals 2 and 3,
  4-step LCM on the zero-init student) from the port's tiny random models
  against the same variants of the JAX ``stage2_generate`` on the weights
  carried across (``pcdms_tpu/compat/torch_convert.py``), the latents
  injected, the VAE's posterior mean, f32 (LCM's draws between steps: the
  port's, given to the JAX loop): each row's PSNR within 0.05 dB and cosine
  within 1e-5. The CLI's tiny run prints the five rows.
* Every ``--flag`` of ``scripts/run_*_torch.sh`` is accepted by the port
  CLI it launches (as ``tests/test_launchers.py`` checks the JAX ones), and
  the launchers name no module of the JAX package.
* ``pyproject.toml`` has the new console scripts.
"""

import dataclasses
import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pcdms_tpu.cli.common import tiny_configs as j_tiny_configs
from pcdms_tpu.compat.torch_convert import (
    convert_image_proj, convert_pose_proj, convert_unet, convert_vae,
)
from pcdms_tpu.pipelines import sampling as j_sampling
from pcdms_tpu.pipelines.stage2_inpaint import stage2_generate as j_stage2
from pcdms_tpu.train.lcm_distill import (
    lcm_boundary_scalings as j_boundary_scalings,
)

from pcdms_tpu_torch.cli import fastpath_drift, serve_client

from _torch_common import one_thread

ROOT = os.path.join(os.path.dirname(__file__), "..")
SCRIPTS = os.path.join(ROOT, "scripts")


@pytest.fixture(autouse=True)
def _one_thread():
    with one_thread():
        yield


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# the serving client
# ---------------------------------------------------------------------------

def test_serve_client_round_trip(tmp_path, capsys):
    from pcdms_tpu_torch.cli.serve import build_deployment, parse_args
    from pcdms_tpu_torch.serve.http import ServingServer
    svc = build_deployment(parse_args([
        "--random_init", "--tiny_config", "--height", "64", "--width", "64",
        "--num_inference_steps", "2", "--no_warmup", "--buckets", "1",
        "--device", "cpu"]))
    out = tmp_path / "serve_out.png"
    with ServingServer(svc, port=0) as server:
        img = serve_client.main(["--port", str(server.port), "--tiny_demo",
                                 "--seed", "3", "--out", str(out)])
    assert img.shape == (64, 128, 3) and np.isfinite(img).all()
    assert np.asarray(Image.open(out)).shape == (64, 128, 3)
    assert "wrote" in capsys.readouterr().out


def test_serve_client_requests_equal_jax(tmp_path):
    j_client = _load(os.path.join(ROOT, "examples", "serve_client.py"),
                     "j_serve_client")
    got = serve_client.tiny_demo_request(64, 64, np.random.default_rng(5))
    want = j_client.tiny_demo_request(64, 64, np.random.default_rng(5))
    rng = np.random.default_rng(6)
    files = {}
    for name in ("source_image", "source_pose", "target_pose"):
        files[name] = str(tmp_path / f"{name}.png")
        Image.fromarray(rng.integers(0, 255, (70, 50, 3), np.uint8)).save(
            files[name])
    np.save(tmp_path / "dino.npy", rng.standard_normal((5, 24)))
    np.save(tmp_path / "embed.npy", rng.standard_normal((1, 16)))
    args = serve_client.parse_args([
        "--port", "1", "--dino_features", str(tmp_path / "dino.npy"),
        "--embed", str(tmp_path / "embed.npy")] + [
        f for k, v in files.items() for f in (f"--{k}", v)])
    for g, w in ((got, want), (serve_client.real_request(args),
                               j_client.real_request(args))):
        assert sorted(g) == sorted(w)
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])


# ---------------------------------------------------------------------------
# the drift table
# ---------------------------------------------------------------------------

def test_psnr_cosine_equal_jax_script():
    j_drift = _load(os.path.join(SCRIPTS, "fastpath_drift.py"), "j_drift")
    rng = np.random.default_rng(7)
    a = rng.uniform(-1, 1, (2, 8, 16, 3)).astype(np.float32)
    b = a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
    # the JAX script's mean is XLA's f32 reduction, the port's numpy's f64
    assert abs(fastpath_drift.psnr(a, b) - j_drift.psnr(jnp.asarray(a),
                                                         jnp.asarray(b))) \
        < 1e-5
    assert fastpath_drift.cosine(a, b) == j_drift.cosine(a, b)


def _lcm_loop_with(noise):
    """JAX ``lcm_sample_loop`` with noise[i] in place of its i-th draw."""
    def loop(schedule, model_eps, x, num_steps, rng, *, origin_steps=50,
             sigma_data=0.5, timestep_scaling=10.0):
        ts = j_sampling.lcm_inference_timesteps(
            schedule.num_train_timesteps, num_steps, origin_steps)
        a = jnp.asarray(schedule.sqrt_alphas_cumprod)
        s = jnp.asarray(schedule.sqrt_one_minus_alphas_cumprod)
        model = jax.jit(model_eps)
        for i, tv in enumerate(ts):
            eps = model(x, jnp.asarray(tv, jnp.int32))
            x0 = (x - s[tv] * eps) / a[tv]
            c_skip, c_out = j_boundary_scalings(
                jnp.asarray(float(tv)), sigma_data, timestep_scaling)
            x = c_skip * x + c_out * x0
            if i < len(ts) - 1:
                x = a[ts[i + 1]] * x + s[ts[i + 1]] * jnp.asarray(noise[i])
        return x
    return loop


def _jparams(models):
    def n(m):
        return {k: v.detach().float().numpy() for k, v in
                m.state_dict().items()}
    return {"unet": convert_unet(n(models["unet"])),
            "vae": convert_vae(n(models["vae"])),
            "image_proj": convert_image_proj(n(models["image_proj"])),
            "pose_proj": convert_pose_proj(n(models["pose_proj"]))}


def test_drift_table_matches_jax(monkeypatch):
    exact_steps = 6
    models, inputs, latents = fastpath_drift.random_setup(
        True, 64, 2, torch.device("cpu"))
    models = {k: m.float() for k, m in models.items()}
    gen = fastpath_drift.make_gen(inputs, latents, torch.device("cpu"),
                                  compute_dtype=torch.float32)
    exact = gen(models, exact_steps)
    rows = [(name, fn()) for name, fn in fastpath_drift.variants(
        gen, models, exact_steps)]

    tiny = j_tiny_configs()
    base_cfg = tiny.unet2(True)
    jparams = _jparams(models)
    student = fastpath_drift.lcm_student(models)
    lcm_params = dict(jparams, unet=convert_unet(
        {k: v.float().numpy() for k, v in
         student["unet"].state_dict().items()}))
    lcm_cfg = dataclasses.replace(
        base_cfg, time_cond_proj_dim=fastpath_drift.LCM_COND_DIM)
    g = torch.Generator().manual_seed(fastpath_drift.LCM_GEN_SEED)
    monkeypatch.setattr(j_sampling, "lcm_sample_loop", _lcm_loop_with(
        [torch.randn(latents.shape, generator=g).numpy() for _ in range(3)]))

    def jgen(steps, scheduler="ddim", interval=1, cfg=base_cfg, p=jparams):
        fn = j_stage2.__wrapped__ if scheduler == "lcm" else j_stage2
        return np.asarray(fn(
            p, *(jnp.asarray(x) for x in inputs), jax.random.PRNGKey(0),
            jnp.asarray(latents), unet_cfg=cfg, vae_cfg=tiny.vae,
            num_steps=steps, guidance_scale=2.0, scheduler=scheduler,
            encoder_cache_interval=interval, deterministic_vae=True,
            compute_dtype=jnp.float32))
    j_exact = jgen(exact_steps)
    want = [jgen(20, "unipc"), jgen(20), jgen(exact_steps, interval=2),
            jgen(exact_steps, interval=3),
            jgen(4, "lcm", cfg=lcm_cfg, p=lcm_params)]
    assert len(rows) == len(want) == 5
    for (name, out), w in zip(rows, want):
        got_p = fastpath_drift.psnr(exact, out)
        want_p = fastpath_drift.psnr(j_exact, w)
        assert abs(got_p - want_p) <= 0.05, (name, got_p, want_p)
        assert abs(fastpath_drift.cosine(exact, out)
                   - fastpath_drift.cosine(j_exact, w)) <= 1e-5, name


def test_drift_cli_tiny_table(capsys):
    rows = fastpath_drift.main(["--tiny", "--device", "cpu",
                                "--exact_steps", "4", "--batch", "1"])
    assert len(rows) == 5
    assert all(np.isfinite(p) and 0 < c <= 1 for _, p, c, _ in rows)
    out = capsys.readouterr().out
    assert out.count("\n| ") == 6          # the header and five rows


def test_drift_trained_mode_needs_its_dirs():
    with pytest.raises(SystemExit, match="--frozen_dir"):
        fastpath_drift.main(["--train_ckpt_dir", "x", "--device", "cpu"])


# ---------------------------------------------------------------------------
# the launchers and the console scripts
# ---------------------------------------------------------------------------

LAUNCHER_CLIS = {
    "run_stage1_torch.sh": ["pcdms_tpu_torch.cli.stage1_train"],
    "run_stage2_torch.sh": ["pcdms_tpu_torch.cli.stage2_train"],
    "run_stage3_torch.sh": ["pcdms_tpu_torch.cli.stage3_train"],
    "run_test_stages_torch.sh": ["pcdms_tpu_torch.cli.stage1_batchtest",
                                 "pcdms_tpu_torch.cli.stage2_batchtest",
                                 "pcdms_tpu_torch.cli.stage3_batchtest",
                                 "pcdms_tpu_torch.cli.calculate_metrics"],
}


def _flags_per_module(text):
    """Each ``-m <module>`` launch -> the --flags that follow it."""
    out, module = {}, None
    for line in text.splitlines():
        m = re.search(r"-m ([\w.]+)", line)
        if m:
            module = m.group(1)
            out.setdefault(module, set())
        if module:
            out[module].update(re.findall(r"--([\w-]+)", line.split(
                " -m ")[-1]))
    return out


def _known_flags(module, monkeypatch):
    import argparse
    mod = __import__(module, fromlist=["parse_args"])
    captured = {}

    def capture(self, args=None, namespace=None):
        captured["parser"] = self
        raise SystemExit(0)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(SystemExit):
        mod.parse_args([])
    monkeypatch.undo()
    return {opt[2:] for a in captured["parser"]._actions
            for opt in a.option_strings if opt.startswith("--")}


@pytest.mark.parametrize("launcher", sorted(LAUNCHER_CLIS))
def test_launcher_flags_accepted(launcher, monkeypatch):
    with open(os.path.join(SCRIPTS, launcher)) as f:
        text = f.read()
    per_module = _flags_per_module(text)
    assert set(per_module) == set(LAUNCHER_CLIS[launcher])
    assert "pcdms_tpu." not in text
    if "train" in launcher:
        assert "torchrun --nproc_per_node" in text
    for module, used in per_module.items():
        unknown = used - _known_flags(module, monkeypatch)
        assert not unknown, (launcher, module, sorted(unknown))


def test_console_scripts_listed():
    with open(os.path.join(ROOT, "pyproject.toml")) as f:
        text = f.read()
    for script, target in (
            ("pcdms-torch-demo", "pcdms_tpu_torch.cli.demo:main"),
            ("pcdms-torch-serve-client",
             "pcdms_tpu_torch.cli.serve_client:main"),
            ("pcdms-torch-fastpath-drift",
             "pcdms_tpu_torch.cli.fastpath_drift:main")):
        assert f'{script} = "{target}"' in text
