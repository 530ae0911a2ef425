"""The serving stack (``pcdms_tpu_torch/serve``, ``cli/serve.py``) on the
CPU at the tiny geometry: every engine case of ``tests/test_serve.py::
TestEngine`` (output kinds as cases of one test), the dispatch thread's
inference mode, ``Stage2Service`` against the JAX package's for the same
request and seed (f32 atol 1e-4 / rtol 1e-3), batch invariance (bucket 1
against packed in bucket 4), input validation and the refused samplers,
``ShapeRouter``, HTTP end to end (400 for an unknown shape, the body limit,
504 on a timeout), ``build_service`` / ``build_deployment`` for both
models, ``CascadeService``'s determinism and seed portability to
``Stage2Service``, and ``mesh=`` / ``--data_parallel`` (the ``mesh=None``
arrays, replicas shared across canvases). Every wait is bounded, and every
engine and server stops in ``finally``."""

import http.client
import json
import threading
import time
from concurrent.futures import Future

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcdms_tpu.serve.stage2 import Stage2Service as JStage2Service

from pcdms_tpu_torch.serve.engine import (
    DynamicBatcher, EngineClosed, InferenceEngine, _Pending,
)
from pcdms_tpu_torch.serve.http import ServingServer, post_npz
from pcdms_tpu_torch.serve.router import ShapeRouter
from pcdms_tpu_torch.serve.stage2 import CascadeService, Stage2Service

from _torch_common import TINY, TOL, stage2_models

WAIT = 60          # seconds any single future or request may take


def wait_until(pred, timeout=10.0, poll=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(poll)
    return False


# ---------------------------------------------------------------------------
# the engine (tests/test_serve.py::TestEngine, case for case)
# ---------------------------------------------------------------------------

OUTPUT_KINDS = {
    "numpy": lambda x: {"y": x * 2.0},
    "tensor": lambda x: {"y": torch.from_numpy(x) * 2.0},
    "nested": lambda x: {"y": [torch.from_numpy(x * 2.0)],
                         "z": (x * 3.0,)},
}


@pytest.mark.parametrize("kind", sorted(OUTPUT_KINDS))
def test_roundtrip_and_routing(kind):
    """Each request's result is its own row, whatever the batch mix and
    whether the model returns numpy, tensors or a nested mix (results come
    back as numpy)."""
    batches = []

    def fn(batch):
        batches.append(batch["x"].shape[0])
        return OUTPUT_KINDS[kind](batch["x"])

    with InferenceEngine(fn, buckets=(1, 2, 4), max_delay_ms=100.0) as eng:
        futs = [eng.submit({"x": np.full((3,), float(i))}) for i in range(3)]
        for i, f in enumerate(futs):
            out = f.result(WAIT)
            y = out["y"][0] if kind == "nested" else out["y"]
            assert isinstance(y, np.ndarray)
            np.testing.assert_array_equal(y, np.full((3,), 2.0 * i))
            if kind == "nested":
                np.testing.assert_array_equal(out["z"][0],
                                              np.full((3,), 3.0 * i))
    assert set(batches) <= {1, 2, 4}


def test_bucket_padding():
    """3 requests in one window -> bucket 4 with one padded slot."""
    sizes = []
    entered, release = threading.Event(), threading.Event()

    def fn(batch):
        entered.set()
        release.wait(30)
        sizes.append(batch["x"].shape[0])
        return batch["x"]

    eng = InferenceEngine(fn, buckets=(1, 4), max_delay_ms=500.0)
    try:
        f0 = eng.submit({"x": np.zeros(2)})
        assert entered.wait(10)
        futs = [eng.submit({"x": np.full(2, float(i))}) for i in range(3)]
        release.set()
        [f.result(WAIT) for f in [f0] + futs]
    finally:
        release.set()
        eng.close(timeout=WAIT)
    assert sizes[-1] == 4                          # 3 real + 1 pad
    st = eng.stats()
    assert st["completed"] == 4
    assert st["padded_slots"] >= 1
    assert 0 < st["batch_occupancy"] <= 1


def test_error_isolation():
    """A failing batch fails its own futures; the engine keeps going."""
    def fn(batch):
        if batch["x"][0, 0] < 0:
            raise RuntimeError("boom")
        return batch["x"] + 1

    with InferenceEngine(fn, buckets=(1,), max_delay_ms=1.0) as eng:
        bad = eng.submit({"x": np.full((1,), -1.0)})
        with pytest.raises(RuntimeError, match="boom"):
            bad.result(WAIT)
        good = eng.submit({"x": np.full((1,), 5.0)})
        np.testing.assert_array_equal(good.result(WAIT), [6.0])
    assert eng.stats()["failed"] == 1


def test_close_drains_queued_requests():
    def fn(batch):
        time.sleep(0.01)
        return batch["x"]

    eng = InferenceEngine(fn, buckets=(2,), max_delay_ms=1.0)
    try:
        futs = [eng.submit({"x": np.full(1, float(i))}) for i in range(6)]
    finally:
        eng.close(drain=True, timeout=WAIT)
    for i, f in enumerate(futs):
        np.testing.assert_array_equal(f.result(1), [float(i)])


def test_close_no_drain_fails_queued():
    release = threading.Event()

    def fn(batch):
        release.wait(30)
        return batch["x"]

    eng = InferenceEngine(fn, buckets=(1,), max_delay_ms=1.0)
    try:
        first = eng.submit({"x": np.zeros(1)})
        assert wait_until(lambda: eng._batcher.pending() == 0, 5)
        queued = eng.submit({"x": np.ones(1)})
        closer = threading.Thread(target=eng.close, kwargs={"drain": False})
        closer.start()
        release.set()
        closer.join(WAIT)
        assert not closer.is_alive()
    finally:
        release.set()
        eng.close(timeout=WAIT)
    np.testing.assert_array_equal(first.result(1), [0.0])
    with pytest.raises(EngineClosed):
        queued.result(1)


def test_pipelined_dispatch():
    """The dispatch thread launches batch N+1 while batch N's result is
    still being read back: the model returns a lazy object whose host
    conversion blocks, and a second model call must happen before the first
    future resolves."""
    gate = threading.Event()
    calls = []

    class LazyResult:
        def __init__(self, arr):
            self.arr = arr

        def __array__(self, dtype=None, copy=None):
            gate.wait(30)
            return self.arr

    def fn(batch):
        calls.append(batch["x"].shape[0])
        return LazyResult(batch["x"] + 1)

    eng = InferenceEngine(fn, buckets=(1,), max_delay_ms=1.0, max_inflight=2)
    try:
        f1 = eng.submit({"x": np.zeros(1)})
        f2 = eng.submit({"x": np.ones(1)})
        assert wait_until(lambda: len(calls) == 2, 10), calls
        assert not f1.done()
        gate.set()
        np.testing.assert_array_equal(f1.result(WAIT), [1.0])
        np.testing.assert_array_equal(f2.result(WAIT), [2.0])
    finally:
        gate.set()
        eng.close(timeout=WAIT)


def test_cancelled_future_is_skipped():
    """A client cancel() on a queued request must not kill the dispatch
    thread."""
    release = threading.Event()

    def fn(batch):
        release.wait(30)
        return batch["x"]

    eng = InferenceEngine(fn, buckets=(1,), max_delay_ms=1.0)
    try:
        first = eng.submit({"x": np.zeros(1)})
        assert wait_until(lambda: eng._batcher.pending() == 0, 5)
        second = eng.submit({"x": np.ones(1)})
        assert second.cancel()
        release.set()
        np.testing.assert_array_equal(first.result(WAIT), [0.0])
        third = eng.submit({"x": np.full(1, 3.0)})
        np.testing.assert_array_equal(third.result(WAIT), [3.0])
        assert wait_until(lambda: eng.stats()["cancelled"] == 1, 5), \
            eng.stats()
    finally:
        release.set()
        eng.close(timeout=WAIT)


def test_submit_after_close_raises():
    eng = InferenceEngine(lambda b: b["x"], buckets=(1,))
    eng.close(timeout=WAIT)
    with pytest.raises(EngineClosed):
        eng.submit({"x": np.zeros(1)})


def test_warmup_runs_every_bucket():
    sizes = []

    def fn(batch):
        sizes.append(batch["x"].shape[0])
        return batch["x"]

    with InferenceEngine(fn, buckets=(1, 2, 8)) as eng:
        eng.warmup({"x": np.zeros(3)})
    assert sizes[:3] == [1, 2, 8]


def test_batcher_window():
    b = DynamicBatcher(max_batch=4, max_delay_s=0.05)
    assert b.collect(poll_s=0.01) == []
    for i in range(6):
        b.put(_Pending({"i": np.asarray(i)}, Future(), time.monotonic()))
    assert len(b.collect()) == 4                   # capped at max_batch
    assert len(b.collect()) == 2                   # remainder


def test_dispatch_and_warmup_run_in_inference_mode():
    """Grad mode is per thread: the engine enters inference mode in its own
    dispatch thread and in warmup, whatever the caller's thread runs."""
    seen = []

    def fn(batch):
        seen.append(torch.is_inference_mode_enabled())
        w = torch.ones(1, requires_grad=True)
        out = torch.from_numpy(batch["x"]) * w
        seen.append(out.requires_grad)
        return out

    assert not torch.is_inference_mode_enabled()
    with InferenceEngine(fn, buckets=(1,), max_delay_ms=1.0) as eng:
        eng.warmup({"x": np.zeros(1, np.float32)})
        eng.submit({"x": np.ones(1, np.float32)}).result(WAIT)
    assert seen == [True, False, True, False]


# ---------------------------------------------------------------------------
# Stage2Service against the JAX package's
# ---------------------------------------------------------------------------

H = W = 64
DINO_SHAPE = (5, 24)
SERVICE_KW = dict(height=H, width=W, num_steps=2, guidance_scale=2.0,
                  scheduler="unipc", dino_tokens=DINO_SHAPE[0],
                  dino_dim=DINO_SHAPE[1], embed_dim=16, max_delay_ms=30.0)


@pytest.fixture(scope="module")
def models():
    """(JAX stage-2 params, port stage-2 modules) with the same non-zero
    weights."""
    jtrain, jvae, ttrain, tvae = stage2_models(TINY.unet2(True), 40)
    return {**jtrain, "vae": jvae}, {**ttrain, "vae": tvae}


def make_service(models, **kw):
    args = dict(SERVICE_KW, compute_dtype=torch.float32,
                buckets=(1, 2, 4), device="cpu")
    args.update(kw)
    return Stage2Service(models[1], **args)


def request_inputs(i, seed=0):
    rng = np.random.default_rng(100 + i)
    return dict(
        vae_image=rng.uniform(-1, 1, (H, 2 * W, 3)).astype(np.float32),
        st_pose=rng.uniform(-1, 1, (H, 2 * W, 3)).astype(np.float32),
        dino_features=rng.normal(size=DINO_SHAPE).astype(np.float32),
        embed=rng.normal(size=(16,)).astype(np.float32),
        seed=seed)


def test_stage2_service_matches_jax(models):
    """The same request and seed through both services: the same initial
    latents (the host Philox stream of the seed), the same image."""
    reqs = [request_inputs(i, seed=10 + i) for i in range(2)]
    jsvc = JStage2Service(models[0], unet_cfg=TINY.unet2(True),
                          vae_cfg=TINY.vae, compute_dtype=jnp.float32,
                          buckets=(1,), **SERVICE_KW)
    try:
        want = [jsvc.submit(**r).result(300) for r in reqs]
    finally:
        jsvc.close()
    svc = make_service(models, buckets=(1,))
    try:
        got = [svc.submit(**r).result(WAIT) for r in reqs]
    finally:
        svc.close()
    for g, w in zip(got, want):
        assert g.shape == np.shape(w) == (H, 2 * W, 3)
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


def test_batch_invariance(models):
    """A request alone (bucket 1) and packed with three others (bucket 4)
    gives the same image: per-request latents, the VAE's posterior mean,
    UniPC."""
    svc = make_service(models)
    try:
        fn = svc.engine._batch_fn

        def pack(reqs):
            from pcdms_tpu_torch.serve.stage2 import _request_latents
            with torch.inference_mode():
                return fn({
                    "vae_image": np.stack([r["vae_image"] for r in reqs]),
                    "st_pose": np.stack([r["st_pose"] for r in reqs]),
                    "dino": np.stack([r["dino_features"] for r in reqs]),
                    "embed": np.stack([r["embed"] for r in reqs]),
                    "latents": np.stack([_request_latents(
                        r["seed"], H // 8, 2 * W // 8) for r in reqs]),
                }).numpy()

        a, b, c, d = (request_inputs(i, seed=i) for i in range(4))
        alone, packed = pack([a]), pack([b, a, c, d])
        np.testing.assert_allclose(packed[1], alone[0], rtol=1e-5, atol=1e-5)
    finally:
        svc.close()


def test_submit_end_to_end(models):
    svc = make_service(models)
    try:
        reqs = [request_inputs(i, seed=i) for i in range(3)]
        imgs = [f.result(WAIT) for f in [svc.submit(**r) for r in reqs]]
        for img in imgs:
            assert img.shape == (H, 2 * W, 3) and np.isfinite(img).all()
        again = svc.submit(**reqs[0]).result(WAIT)
        np.testing.assert_allclose(again, imgs[0], rtol=1e-5, atol=1e-5)
        other = svc.submit(**{**reqs[0], "seed": 99}).result(WAIT)
        assert np.abs(other - imgs[0]).max() > 1e-3
        st = svc.stats()
        assert st["completed"] >= 5 and st["failed"] == 0
    finally:
        svc.close()


def test_input_validation(models):
    svc = make_service(models)
    try:
        r = request_inputs(0)
        with pytest.raises(ValueError, match="vae_image"):
            svc.submit(**{**r, "vae_image": np.zeros((8, 8, 3))})
        with pytest.raises(ValueError, match="embed"):
            svc.submit(**{**r, "embed": None})
        with pytest.raises(ValueError, match="dino_features"):
            svc.submit(**{**r, "dino_features": np.zeros((4, 24))})
    finally:
        svc.close()
    simple = make_service(
        (None, {**models[1], "unet": _simple_unet()}), simple_variant=True)
    try:
        with pytest.raises(ValueError, match="no prior embedding"):
            simple.submit(**request_inputs(0))
    finally:
        simple.close()


def _simple_unet():
    from pcdms_tpu_torch.models.unet2d import UNet2DConditionModel
    return UNet2DConditionModel(TINY.unet2(False)).eval()


# lcm draws its noise from the batch's generator; ddpm (an ancestral
# sampler) is not a serving scheduler either
@pytest.mark.parametrize("scheduler", ["lcm", "ddpm"])
def test_nondeterministic_scheduler_rejected(models, scheduler):
    with pytest.raises(ValueError, match="determinism"):
        make_service(models, scheduler=scheduler)
    with pytest.raises(ValueError, match="determinism"):
        CascadeService(None, None, None, scheduler=scheduler, device="cpu")


def test_mesh_and_data_parallel_build(models):
    """``mesh=`` (a list of devices, one replica each) answers each request
    with the array ``mesh=None`` gives at the replica's share of the
    bucket; buckets the devices do not divide raise the JAX service's
    ValueError; ``--data_parallel`` builds over the visible devices."""
    reqs = [request_inputs(i) for i in range(3)]
    with make_service(models, buckets=(1,)) as single, \
            make_service(models, mesh=["cpu", "cpu"], buckets=(2,)) as dp:
        want = [single.submit(**r).result(WAIT) for r in reqs]
        got = [dp.submit(**r).result(WAIT) for r in reqs]
        assert dp.stats()["batches"] == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match=r"buckets \[1\] not divisible"):
        make_service(models, mesh=["cpu", "cpu"], buckets=(1, 2))
    with pytest.raises(ValueError, match="not divisible by the mesh's 2"):
        CascadeService(None, None, None, mesh=["cpu", "cpu"],
                       buckets=(1, 2), device="cpu")
    from pcdms_tpu_torch.cli.serve import build_deployment, visible_devices
    args = _cli_args("--data_parallel")
    assert visible_devices(args) == [torch.device("cpu")]
    svc = build_deployment(args)
    try:
        assert svc.submit(**reqs[0]).result(WAIT).shape == want[0].shape
    finally:
        svc.close()


def test_data_parallel_replicas_shared(models, monkeypatch):
    """Under ``--data_parallel`` the services of every canvas run on one set
    of replicas: a module is copied once to a device that lacks it, and
    every service shares that copy."""
    from pcdms_tpu_torch.cli import serve as serve_cli
    from pcdms_tpu_torch.serve.stage2 import _replica
    monkeypatch.setattr(serve_cli, "visible_devices",
                        lambda args: [torch.device("cpu")] * 2)
    dep = serve_cli.build_deployment(_cli_args(
        "--data_parallel", "--buckets", "2", "--canvas", "64", "64",
        "--canvas", "64", "128"))
    try:
        a, b = dep._by_canvas.values()
        assert len(a._dp.replicas) == len(b._dp.replicas) == 2
        for (reps,) in a._dp.replicas + b._dp.replicas:
            assert reps.keys() == a._models.keys()
            for k, m in reps.items():
                assert m is a._models[k]
    finally:
        dep.close()
    meta = torch.device("meta")
    first, again = _replica(models[1], meta), _replica(models[1], meta)
    for k, m in models[1].items():
        assert first[k] is again[k] and first[k] is not m
        assert next(first[k].parameters()).device == meta


def test_device_defaults_to_cuda(models):
    """No silent CPU fallback: device=None means CUDA."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Stage2Service(models[1], **SERVICE_KW)


# ---------------------------------------------------------------------------
# the router and the HTTP front end
# ---------------------------------------------------------------------------

def test_router_routes_by_canvas_and_rejects_unknown(models):
    svc_wide = make_service(models, height=H, width=2 * W)
    svc_std = make_service(models)
    with ShapeRouter([svc_wide, svc_std]) as router:
        assert router.canvases == [(H, 2 * W), (H, 4 * W)]
        std = request_inputs(0)
        assert router.submit(**std).result(WAIT).shape == (H, 2 * W, 3)
        rng = np.random.default_rng(0)
        wide = dict(std, vae_image=rng.uniform(-1, 1, (H, 4 * W, 3)).astype(
            np.float32), st_pose=rng.uniform(-1, 1, (H, 4 * W, 3)).astype(
                np.float32))
        assert router.submit(**wide).result(WAIT).shape == (H, 4 * W, 3)
        with pytest.raises(ValueError, match="no service for canvas"):
            router.submit(**dict(std, vae_image=np.zeros((48, 96, 3),
                                                         np.float32)))
        st = router.stats()
        assert st[f"{H}x{4 * W}"]["completed"] == 1
        assert st[f"{H}x{2 * W}"]["completed"] == 1


def test_router_rejects_duplicate_canvas(models):
    a = make_service(models, num_steps=1)
    b = make_service(models, num_steps=2)
    try:
        with pytest.raises(ValueError, match="duplicate service"):
            ShapeRouter([a, b])
    finally:
        a.close()
        b.close()


def test_http_end_to_end(models):
    svc = make_service(models)
    with ServingServer(svc, port=0) as server:
        port = server.port
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=WAIT)
        try:
            conn.request("GET", "/healthz")
            assert json.loads(conn.getresponse().read()) == {"ok": True}
            conn.request("GET", "/stats")
            assert "completed" in json.loads(conn.getresponse().read())
        finally:
            conn.close()
        reqs = [request_inputs(i, seed=i) for i in range(2)]
        outs = [None, None]

        def call(i):
            outs[i] = post_npz("127.0.0.1", port, reqs[i], timeout=WAIT)

        threads = [threading.Thread(target=call, args=(i,)) for i in range(2)]
        [th.start() for th in threads]
        [th.join(WAIT) for th in threads]
        assert not any(th.is_alive() for th in threads)
        for o in outs:
            assert o is not None and o["image"].shape == (H, 2 * W, 3)
        direct = svc.submit(**reqs[0]).result(WAIT)
        np.testing.assert_array_equal(outs[0]["image"], direct)
        with pytest.raises(RuntimeError, match="HTTP 400"):
            post_npz("127.0.0.1", port, {**reqs[0], "vae_image": np.zeros(
                (4, 4, 3), np.float32)}, timeout=WAIT)
        ok = post_npz("127.0.0.1", port, reqs[0], timeout=WAIT)
        assert ok["image"].shape == (H, 2 * W, 3)


def test_http_body_size_limit(models):
    svc = make_service(models)
    with ServingServer(svc, port=0, max_body_bytes=1024) as server:
        with pytest.raises(RuntimeError, match="HTTP 413"):
            post_npz("127.0.0.1", server.port, request_inputs(0),
                     timeout=WAIT)


def test_http_request_timeout_replies_504():
    """A request whose result misses request_timeout_s gets a 504 and its
    future is cancelled; the server keeps serving."""

    class StalledService:
        def __init__(self):
            self.futures = []

        def submit(self, timeout=None, **inputs):
            fut = Future()
            self.futures.append(fut)
            return fut

        def stats(self):
            return {}

        def close(self, drain=True):
            pass

    svc = StalledService()
    with ServingServer(svc, port=0, request_timeout_s=0.2) as server:
        with pytest.raises(RuntimeError, match="HTTP 504"):
            post_npz("127.0.0.1", server.port,
                     {"x": np.zeros((2,), np.float32)}, timeout=WAIT)
        assert svc.futures[0].cancelled()


# ---------------------------------------------------------------------------
# the serve CLI and CascadeService
# ---------------------------------------------------------------------------

def _cli_args(*extra):
    from pcdms_tpu_torch.cli.serve import parse_args
    return parse_args(["--random_init", "--tiny_config", "--height", "64",
                       "--width", "64", "--num_inference_steps", "2",
                       "--no_warmup", "--buckets", "1", "2", "--device",
                       "cpu", *extra])


def _cascade_request(seed):
    r = request_inputs(0)
    rng = np.random.default_rng(0)
    return dict(s_embed=rng.normal(size=(16,)).astype(np.float32),
                s_pose=np.full((36,), 0.4, np.float32),
                t_pose=np.full((36,), 0.6, np.float32),
                vae_image=r["vae_image"], st_pose=r["st_pose"],
                dino_features=r["dino_features"], seed=seed)


@pytest.fixture(scope="module")
def cascade_service():
    from pcdms_tpu_torch.cli.serve import build_service
    svc = build_service(_cli_args("--model", "cascade"))
    yield svc
    svc.close()


@pytest.mark.parametrize("model", ["stage2", "cascade"])
def test_build_service(model):
    from pcdms_tpu_torch.cli.serve import build_service
    svc = build_service(_cli_args("--model", model))
    try:
        if model == "stage2":
            assert isinstance(svc, Stage2Service)
            r = request_inputs(0)
            img = svc.submit(**r).result(WAIT)
            assert img.shape == (H, 2 * W, 3) and np.isfinite(img).all()
        else:
            assert isinstance(svc, CascadeService)
            out = svc.submit(**_cascade_request(5)).result(WAIT)
            assert out["refined"].shape == (H, W, 3)
            assert out["inpainted"].shape == (H, 2 * W, 3)
            assert out["embeds"].shape == (16,)
            assert all(np.isfinite(v).all() for v in out.values())
    finally:
        svc.close()


def test_cascade_same_seed_same_bits(cascade_service):
    out = cascade_service.submit(**_cascade_request(5)).result(WAIT)
    again = cascade_service.submit(**_cascade_request(5)).result(WAIT)
    for key in out:
        np.testing.assert_array_equal(out[key], again[key])
    other = cascade_service.submit(**_cascade_request(6)).result(WAIT)
    assert not np.allclose(out["refined"], other["refined"])


def test_seed_portable_across_services(cascade_service):
    """A cascade's predicted embedding fed to a stage-2 service with the
    same seed and weights reproduces the cascade's stage-2 image."""
    from pcdms_tpu_torch.cli.serve import build_service, load_service_params
    req = _cascade_request(7)
    out = cascade_service.submit(**req).result(WAIT)
    params = load_service_params(_cli_args("--model", "cascade"))
    svc = build_service(_cli_args("--model", "stage2"), params=params)
    try:
        img = svc.submit(vae_image=req["vae_image"], st_pose=req["st_pose"],
                         dino_features=req["dino_features"],
                         embed=out["embeds"], seed=7).result(WAIT)
    finally:
        svc.close()
    np.testing.assert_allclose(img, out["inpainted"], rtol=1e-5, atol=1e-5)


def test_multi_canvas_deployment_over_http():
    """--canvas H W (repeatable): one engine per canvas sharing one set of
    modules behind a ShapeRouter and one port; unknown shapes get 400."""
    from pcdms_tpu_torch.cli.serve import build_deployment
    dep = build_deployment(_cli_args("--model", "stage2", "--canvas", "64",
                                     "64", "--canvas", "64", "128"))
    assert isinstance(dep, ShapeRouter)
    assert dep.canvases == [(64, 128), (64, 256)]
    services = list(dep._by_canvas.values())
    assert services[0]._models is services[1]._models
    with ServingServer(dep, port=0) as server:
        std = request_inputs(0)
        out = post_npz("127.0.0.1", server.port, std, timeout=WAIT)
        assert out["image"].shape == (64, 128, 3)
        rng = np.random.default_rng(1)
        wide = dict(std, vae_image=rng.uniform(-1, 1, (64, 256, 3)).astype(
            np.float32), st_pose=rng.uniform(-1, 1, (64, 256, 3)).astype(
                np.float32))
        out = post_npz("127.0.0.1", server.port, wide, timeout=WAIT)
        assert out["image"].shape == (64, 256, 3)
        with pytest.raises(RuntimeError, match="HTTP 400"):
            post_npz("127.0.0.1", server.port, dict(
                std, vae_image=np.zeros((48, 96, 3), np.float32)),
                timeout=WAIT)


def test_serve_cli_refuses_like_jax():
    from pcdms_tpu_torch.cli.serve import load_service_params, main
    with pytest.raises(SystemExit, match="stage2-only"):
        main(["--model", "cascade", "--simple_variant", "--device", "cpu"])
    args = _cli_args()
    args.random_init = False
    with pytest.raises(SystemExit, match="--weights_name required"):
        load_service_params(args)
