"""The LCM distillation CLI (``cli/lcm_distill.py``) on the CPU at the tiny
geometry: the counterpart of the JAX package's CLI test with the same flags
(``--zero1`` at a world of 1 included), a bit-exact resume, the
``--weights_name`` and ``--train_ckpt_dir`` teacher branches on files saved
from seeded inits, and a 4-step LCM sample from the distilled student."""

import logging
import os
import re

import numpy as np
import pytest
import torch

from pcdms_tpu_torch.cli import lcm_distill as cli, stage2_train
from pcdms_tpu_torch.models.projections import (
    ImageProjModel, PoseCondEmbedding,
)
from pcdms_tpu_torch.models.unet2d import UNet2DConditionModel, UNetConfig
from pcdms_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from pcdms_tpu_torch.parallel.dryrun import tiny_batch
from pcdms_tpu_torch.train import checkpoint as ckpt
from pcdms_tpu_torch.train.frozen import load_frozen, load_trained_params

from _torch_common import TINY, one_thread, port_config


ARGV = ["--tiny_config", "--random_init", "--synthetic_data",
        "--checkpointing_steps", "100", "--train_batch_size", "8",
        "--img_height", "64", "--img_width", "64", "--learning_rate", "1e-3",
        "--lr_warmup_steps", "1", "--log_every", "1", "--mixed_precision",
        "no", "--num_ddim_timesteps", "10", "--zero1", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    with one_thread():
        yield


def _step_keyed_batches(args, clip, dino, aux=None, mesh=None):
    """A batch stream whose batch of step n is ``tiny_batch(2, n)`` also
    when the run resumes at its last checkpoint (the synthetic stream starts
    over), so that a resumed run and an uninterrupted one see the same
    data."""
    step = (ckpt.latest_step(args.output_dir) or 0
            if args.resume_from_checkpoint else 0)
    while True:
        yield tiny_batch(2, step)
        step += 1


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The JAX test's run (4 steps, --zero1); on a step-keyed stream, a run
    of 4 steps and one stopped at step 2 and resumed to 4."""
    tmp = tmp_path_factory.mktemp("lcm_cli")
    handler, logger = _Records(), logging.getLogger("pcdms_tpu_torch.train")
    level = logger.level
    logger.addHandler(handler)
    logger.setLevel(logging.INFO)
    try:
        full = cli.main(ARGV + ["--output_dir", str(tmp / "full"),
                                "--max_train_steps", "4"])
        losses = handler.losses()
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(stage2_train, "make_batches", _step_keyed_batches)
        keyed = cli.main(ARGV + ["--output_dir", str(tmp / "keyed"),
                                 "--max_train_steps", "4"])
        cli.main(ARGV + ["--output_dir", str(tmp / "cut"),
                         "--max_train_steps", "2"])
        resumed = cli.main(ARGV + ["--output_dir", str(tmp / "cut"),
                                   "--max_train_steps", "4",
                                   "--resume_from_checkpoint"])
    return tmp, full, losses, (keyed, resumed)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())

    def losses(self):
        return [float(m.group(1)) for msg in self.messages
                if (m := re.match(r"step \d+ loss ([-\d.einfa]+)", msg))]


def test_cli_main_tiny_synthetic(cli_runs):
    """The counterpart of the JAX CLI test: 4 finite losses, the last
    checkpoint at step 4, ZeRO-1 on at a world of 1 (no group: the plain
    optimizer)."""
    tmp, full, losses, _ = cli_runs
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert ckpt.latest_step(tmp / "full") == 4 and full.step == 4
    assert not full.zero1
    cond = full.models["unet"].time_embedding.cond_proj.weight
    assert float(cond.detach().abs().sum()) > 0   # the w-projection trained


def test_cli_resume_is_bit_exact(cli_runs):
    """Stopped at step 2 and resumed, the run ends where the uninterrupted
    one does, bit for bit: parameters and AdamW moments."""
    keyed, resumed = cli_runs[3]
    assert resumed.step == keyed.step == 4
    for (name, a), (_, b) in zip(keyed.named, resumed.named):
        assert torch.equal(a, b), name
    want, got = (s.optimizer.state_dict()["state"] for s in (keyed, resumed))
    for i, moments in want.items():
        for key, v in moments.items():
            assert torch.equal(got[i][key], v), (i, key)


def test_distilled_student_samples_four_lcm_steps(cli_runs):
    from pcdms_tpu_torch.pipelines.stage2_inpaint import stage2_generate
    _, full, _, _ = cli_runs
    torch.manual_seed(0)
    models = dict(full.models, vae=AutoencoderKL(port_config(TINY.vae,
                                                             VAEConfig)))
    rng = np.random.default_rng(0)
    out = stage2_generate(
        models, rng.uniform(-1, 1, (1, 64, 128, 3)).astype(np.float32),
        rng.uniform(-1, 1, (1, 64, 128, 3)).astype(np.float32),
        rng.standard_normal((1, 5, 24)).astype(np.float32),
        rng.standard_normal((1, 1, 16)).astype(np.float32),
        torch.Generator().manual_seed(1), num_steps=4, scheduler="lcm",
        guidance_scale=2.0, compute_dtype=torch.float32, device="cpu")
    assert out.shape == (1, 64, 128, 3) and torch.isfinite(out).all()


def _save_stage2_checkpoint(path, seed):
    """A monolithic stage-2 checkpoint (the reference's key prefixes) of a
    seeded tiny init; returns the state dicts written."""
    torch.manual_seed(seed)
    parts = {"unet": UNet2DConditionModel(port_config(TINY.unet2(True),
                                                      UNetConfig)),
             "pose_proj": PoseCondEmbedding(**TINY.pose_proj_kwargs),
             "image_proj_model_p": ImageProjModel(**TINY.image_proj_kwargs)}
    sds = {k: {name: v + 0.01 for name, v in m.state_dict().items()}
           for k, m in parts.items()}
    torch.save({f"{k}.{name}": v for k, sd in sds.items()
                for name, v in sd.items()}, path)
    return sds


def test_cli_weights_name_branch(tmp_path):
    """``--weights_name`` reads the teacher from a stage-2 checkpoint and
    ``--pretrained_model_name_or_path`` the VAE; the student starts as the
    teacher. Without a teacher's weights the CLI exits, as the JAX one."""
    sds = _save_stage2_checkpoint(tmp_path / "s2.pt", 3)
    torch.manual_seed(4)
    vae = AutoencoderKL(port_config(TINY.vae, VAEConfig))
    os.makedirs(tmp_path / "sd21" / "vae")
    torch.save(vae.state_dict(),
               tmp_path / "sd21" / "vae" / "diffusion_pytorch_model.bin")
    argv = [a for a in ARGV if a != "--random_init"] + [
        "--weights_name", str(tmp_path / "s2.pt"),
        "--pretrained_model_name_or_path", str(tmp_path / "sd21"),
        "--output_dir", str(tmp_path / "out"), "--max_train_steps", "1"]
    teacher, student, tvae, *_ = cli.build_models(cli.parse_args(argv),
                                                  "cpu")
    for name, part in (("unet", "unet"), ("pose_proj", "pose_proj"),
                       ("image_proj", "image_proj_model_p")):
        for key, v in sds[part].items():
            assert torch.equal(teacher[name].state_dict()[key], v), key
            assert torch.equal(student[name].state_dict()[key], v), key
    for key, v in vae.state_dict().items():
        assert torch.equal(tvae.state_dict()[key], v), key
    with pytest.raises(SystemExit, match="--weights_name or "
                                         "--train_ckpt_dir"):
        cli.main([a for a in argv if a not in ("--weights_name",
                                               str(tmp_path / "s2.pt"))])


def test_cli_train_ckpt_dir_branch(tmp_path):
    """``--train_ckpt_dir`` takes the EMA of a port stage-2 run as the
    teacher, with that run's ``--frozen_dir``."""
    from pcdms_tpu_torch.cli.stage2_train import main as s2_main
    run, frozen = str(tmp_path / "s2"), str(tmp_path / "frozen")
    s2_main(["--tiny_config", "--random_init", "--synthetic_data",
             "--device", "cpu", "--output_dir", run, "--img_height", "64",
             "--img_width", "64", "--train_batch_size", "2",
             "--max_train_steps", "1", "--use_ema", "--lr_warmup_steps", "0",
             "--frozen_dir", frozen])
    ema = load_trained_params(run)
    argv = [a for a in ARGV if a != "--random_init"] + [
        "--train_ckpt_dir", run, "--frozen_dir", frozen,
        "--output_dir", str(tmp_path / "out"), "--max_train_steps", "1"]
    teacher, student, vae, *_ = cli.build_models(cli.parse_args(argv), "cpu")
    raw = ckpt.load_payload(run)[0]["models"]["unet"]
    moved = 0
    for key, v in ema["unet"].items():
        assert torch.equal(teacher["unet"].state_dict()[key], v), key
        assert torch.equal(student["unet"].state_dict()[key], v), key
        moved += not torch.equal(raw[key], v)
    assert moved                                 # the EMA, not the raw run
    for key, v in load_frozen(frozen)["vae"].items():
        assert torch.equal(vae.state_dict()[key], v), key
