"""The yardstick's arithmetic on the CPU: the analytic work counts against
PyTorch's own flop counter and hand counts, the roofline's larger bound,
the tail over all requests, the open-loop schedule, and the frozen
reference against the program in f32 at tiny sizes (this test imports
both; the reference imports nothing of the program)."""

import math
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch
from torch.utils import flop_counter
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops, harness, weights
from benchmark.drivers import sample as sample_driver
from benchmark.drivers import serve_open_loop as sol
from benchmark.drivers.sample import rel_l2
from benchmark.reference import nets as ref_nets
from benchmark.tests import tiny

CFG2 = tiny.tiny_config(harness.load_cell("s2-sample-b8-unipc20").config)
CFG3 = tiny.tiny_config(harness.load_cell("s3-sample-b16-unipc20").config)


def _counted(fn):
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def _reference(cfg, name):
    with torch.device("meta"):
        m = ref_nets.NETS[name](cfg[name])
    drawn = weights.draw(weights.specs(m), 3, "cpu", torch.float32)
    return weights.install(m, drawn)


@pytest.mark.parametrize("cfg", [CFG2, CFG3], ids=["stage2", "stage3"])
def test_unet_count_matches_flop_counter(cfg):
    unet = _reference(cfg, "unet")
    u = cfg["unet"]
    b, h, w, ctx = 2, 16, 24, 7
    x = torch.randn(b, h, w, u["in_channels"])
    c = torch.randn(b, ctx, u["cross_attention_dim"])
    cls = (torch.randn(b, u["class_embed_proj_dim"])
           if u["class_embed_proj_dim"] else None)
    counted = _counted(lambda: unet(x, torch.tensor([5.0, 900.0]), c, cls))
    assert flops.unet(u, b, h, w, ctx) == counted
    # the CFG-unconditional rows' cross-attention is not useful work
    assert flops.unet(u, b, h, w, ctx, cross_rows=1) < counted


def test_vae_and_projection_counts_match_flop_counter():
    vae = _reference(CFG2, "vae")
    img = torch.rand(2, 32, 48, 3) * 2 - 1
    assert flops.vae_encode(CFG2["vae"], 2, 32, 48) == _counted(
        lambda: vae.encode_mean(img))
    z = torch.randn(2, 4, 6, 4)
    assert flops.vae_decode(CFG2["vae"], 2, 4, 6) == _counted(
        lambda: vae.decode(z))
    proj = _reference(CFG2, "image_proj")
    assert flops.image_proj(CFG2["image_proj"], 3, 5) == _counted(
        lambda: proj(torch.randn(3, 5, 24)))
    pose = _reference(CFG2, "pose_proj")
    assert flops.pose_proj(CFG2["pose_proj"], 2, 32, 48) == _counted(
        lambda: pose(torch.randn(2, 32, 48, 3)))


@pytest.mark.parametrize("shape", [(6, 64, 48, 16), (80, 8192, 8192, 64)])
def test_attention_train_count_matches_sdpa_formulas(shape):
    """Forward and backward with one recompute of the scores: PyTorch's
    SDPA counts, 14 B*H*Lq*Lk*d."""
    bh, lq, lk, d = shape
    q, k = (1, bh, lq, d), (1, bh, lk, d)
    counted = (flop_counter.sdpa_flop_count(q, k, k)
               + flop_counter.sdpa_backward_flop_count(q, q, k, k))
    assert flops.attention_train(*shape) == counted == 14 * bh * lq * lk * d
    assert flops.attention_train(*shape) == 3.5 * flops.attention(*shape)


def test_hand_counts():
    assert flops.attention(80, 8192, 8192, 64) == 4 * 80 * 8192 ** 2 * 64
    assert flops.attention_bytes(80, 8192, 8192, 64) == 2 * 80 * 64 * 4 * 8192
    assert flops.conv(3, 5, 3, 4, 6) == 2 * 3 * 5 * 9 * 24
    assert flops.linear(7, 11, 13) == 2 * 7 * 11 * 13
    # a resnet at 4 -> 8 channels, 2 x 2, with a 16-wide time embedding
    hand = (2 * 4 * 8 * 9 * 4 + 2 * 8 * 8 * 9 * 4 + 2 * 4 * 8 * 4
            + 2 * 16 * 8)
    assert flops._resnet(4, 8, 2, 2, 16) == hand


def test_roofline_takes_the_larger_bound():
    assert flops.roofline_seconds(10.0, 1.0, 10.0, 10.0) == 1.0
    assert flops.roofline_seconds(1.0, 30.0, 10.0, 10.0) == 3.0
    # the stage-2 level-0 call is bound by its operations
    f, b = flops.attention(80, 8192, 8192, 64), flops.attention_bytes(
        80, 8192, 8192, 64)
    assert flops.roofline_seconds(f, b, 989e12, 3.35e12) == f / 989e12


def test_percentile_over_all_requests():
    lat = [1.0] * 80 + [5.0] * 10 + [9.0] * 10
    assert sol.percentile(lat, 90) == 5.0
    assert sol.percentile(lat + [math.inf], 90) == 9.0
    # chunks of 10, each's p90 averaged, would read 1.8
    chunks = [sol.percentile(lat[i:i + 10], 90) for i in range(0, 100, 10)]
    assert np.mean(chunks) != sol.percentile(lat, 90)
    assert sol.percentile([math.inf] * 3, 90) == math.inf


def test_schedule_fixed_and_poisson_like():
    a = sol.arrival_times(2.0, 51)
    assert np.array_equal(a, sol.arrival_times(2.0, 51))
    assert len(a) == 102 and a[0] == 0.0 and a[-1] < 51
    gaps = np.diff(np.append(a, 51.0))
    # the gaps are the exponential law's quantiles, not evenly spaced
    assert gaps.max() > 5 * np.median(gaps) and gaps.min() < 0.05
    assert not np.all(np.diff(gaps) >= 0)


class _Done:
    def __init__(self, exc=None):
        self.exc = exc

    def done(self):
        return True

    def cancelled(self):
        return False

    def exception(self):
        return self.exc

    def add_done_callback(self, cb):
        cb(self)


def test_latency_timed_from_due():
    due = np.array([0.0, 1.0, 2.0])
    t0 = 100.0
    done = {0: 100.5, 1: 103.0}
    lat, failed = sol.latencies([_Done(), _Done(), _Done()], done, t0, due)
    assert lat[:2] == [0.5, 2.0] and lat[2] == math.inf and failed == 1
    lat, failed = sol.latencies([_Done(ValueError())], {0: 101.0}, t0,
                                due[:1])
    assert lat == [math.inf] and failed == 1


def _resolved(j):
    f = Future()
    f.set_result(j)
    return f


def test_drive_submits_on_schedule():
    due = np.array([0.0, 0.05, 0.1])
    futs, done, t0, late, batch = sol.drive(_resolved, due,
                                            lambda: len(batch_seen))
    assert len(futs) == 3 and set(done) == {0, 1, 2}
    assert all(0 <= x < 0.05 for x in late)
    assert batch == {0: 0, 1: 0, 2: 0}


batch_seen = []


@pytest.mark.parametrize("batch,rows", [(8, 2), (16, 2), (8, 3), (2, 2)])
def test_sample_picks_cover_every_run_of_slots(batch, rows):
    """Two picks take one slot from each half of a batch, on every seed."""
    edges = [g * batch // rows for g in range(rows + 1)]
    seen = set()
    for seed in (0, 1, 2**31 + 9, 2**33 + 5, 7_000_000_001):
        picks = sample_driver.check_picks(seed, 5, batch, rows)
        assert picks == sample_driver.check_picks(seed, 5, batch, rows)
        slots = sorted(j % batch for j in picks)
        assert all(edges[g] <= slots[g] < edges[g + 1] for g in range(rows))
        assert all(0 <= j < 5 * batch for j in picks)
        seen.add(tuple(picks))
    assert len(seen) > 1


def test_serve_picks_first_and_last_of_a_fullest_batch():
    # batches (by the engine's count): 0 -> [0], 1 -> [1, 2, 3], 2 -> [4, 5],
    # 3 -> [6, 7, 8]
    batch_of = {0: 0, 1: 1, 2: 1, 3: 1, 4: 2, 5: 2, 6: 3, 7: 3, 8: 3}
    got = {tuple(sol.check_picks(s, batch_of)) for s in range(20)}
    assert got == {(1, 3), (6, 8)}
    assert sol.check_picks(5, {4: 0}) == [4]
    assert sol.check_picks(5, {}) == []


def _program_f32(cfg, fam, rows, steps):
    from pcdms_tpu_torch.pipelines import stage2_inpaint, stage3_refine
    m = fam.program_models(cfg, 11, torch.device("cpu"))
    kw = dict(latents=rows["latents"], num_steps=steps,
              compute_dtype=torch.float32, deterministic_vae=True,
              device="cpu")
    if "pose_proj" in cfg:
        return stage2_inpaint.stage2_generate(
            m, rows["vae_image"], rows["st_pose"], rows["dino"],
            rows["embed"], **kw)
    return stage3_refine.stage3_generate(m, rows["gen_image"], rows["dino"],
                                         **kw)


@pytest.mark.parametrize("name", ["pcdms_stage2", "pcdms_stage3"])
def test_reference_matches_program_in_f32(name):
    cfg = dict(CFG2 if name == "pcdms_stage2" else CFG3,
               compute_dtype="float32")
    fam = harness.load_module(harness.BENCH / "families" / f"{name}.py")
    rows = fam.make_rows(cfg, [5, 2**40 + 1], torch.device("cpu"))
    out = _program_f32(cfg, fam, rows, 4)
    nets = fam.reference_models(cfg, 11, torch.device("cpu"))
    for i in range(2):
        ref = fam.reference_row(nets, rows, i, {"num_steps": 4,
                                                "guidance_scale": 2.0})
        assert rel_l2(out[i], ref) < 1e-5


def test_weights_same_from_a_seed():
    with torch.device("meta"):
        m = ref_nets.NETS["image_proj"](CFG2["image_proj"])
    a = weights.draw(weights.specs(m), 2**35, "cpu")
    b = weights.draw(weights.specs(m), 2**35, "cpu")
    c = weights.draw(weights.specs(m), 2**35 + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["net.0.weight"], c["net.0.weight"])
    assert a["net.0.weight"].dtype == torch.bfloat16


def test_setup_counted_from_process_start():
    from benchmark import run
    t = run.process_start()
    assert t <= run.T_START <= time.perf_counter()
