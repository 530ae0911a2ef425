"""The port's DeepFashion data path against the JAX package's, on the CPU,
on the DeepFashion-layout fixture of tests/test_datasets.py:

* ``Stage1/2/3Dataset``: ``fetch(i, epoch)`` and ``__getitem__`` sequences
  byte-identical, in both ``embed_refs`` modes, with non-zero drop rates;
  ``batch_iterator`` too, and its ``ValueError`` for a dataset smaller than
  a batch;
* ``DataLoader``: the stream byte-identical to the JAX loader's at 0, 2 and
  4 workers across epoch boundaries; ``prefetch_to_device`` on the CPU;
* the embedding cache built by the port with a tiny DINOv2 carried from
  JAX params: ``index.json`` identical to JAX's ``build_or_load``, rows at
  f32 atol 1e-4 / rtol 1e-3 (both encoders in f32), the f16 store within one
  f16 ulp; each package reads the other's cache; a dropped item reads
  row 0, the encoder's output on a zero image.
"""

import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcdms_tpu.data import datasets as jds
from pcdms_tpu.data.loader import DataLoader as JDataLoader
from pcdms_tpu.data.preprocess import clip_preprocess, load_image
from pcdms_tpu.train import embed_cache as jcache
from pcdms_tpu.train.encoders import dino_features as j_dino_features

from pcdms_tpu_torch.data import datasets as tds
from pcdms_tpu_torch.data.loader import (
    DataLoader, prefetch_to_device, resolve_num_workers,
)
from pcdms_tpu_torch.train import embed_cache as tcache
from pcdms_tpu_torch.train.encoders import dino_features

from _torch_common import TINY, TOL, vit_pair
from test_datasets import fake_df  # noqa: F401  (the shared fixture)

# every ordered pair of the fixture's three images but one: more examples
# than a batch, so shuffles and epochs show
PAIRS = [{"source_image": f"train_all_png/{s}.jpg",
          "target_image": f"train_all_png/{t}.jpg"}
         for s, t in [("a", "b"), ("b", "c"), ("c", "a"), ("a", "c"),
                      ("b", "a")]]
# the stage-3 pairs: the fixture has stage-2 images for these two
S3_PAIRS = PAIRS[:2]


def _datasets(stage, root, embed_refs, seed=5):
    """(port dataset, JAX dataset) on the same pairs and settings."""
    def make(mod):
        pairs = mod.PairList(S3_PAIRS if stage == 3 else PAIRS, str(root))
        if stage == 1:
            return mod.Stage1Dataset(pairs, size=(32, 32),
                                     s_img_drop_rate=0.3, t_img_drop_rate=0.4,
                                     s_pose_drop_rate=0.5,
                                     t_pose_drop_rate=0.6, seed=seed,
                                     embed_refs=embed_refs)
        if stage == 2:
            return mod.Stage2Dataset(pairs, size=(32, 32), imgp_drop_rate=0.5,
                                     imgg_drop_rate=0.5, seed=seed,
                                     embed_refs=embed_refs)
        return mod.Stage3Dataset(pairs, os.path.join(root, "gen"),
                                 size=(32, 32), gen_drop_rate=0.5, seed=seed,
                                 embed_refs=embed_refs)
    return make(tds), make(jds)


def _assert_same(got, want):
    """Two examples or batches: the same keys, dtypes and bytes."""
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g, w), k


def _drops(examples):
    """(conditions dropped, conditions in all): a float array of zeros, or
    a dropout flag (``embed_refs``) set."""
    flags = [bool(v) if k.endswith("_drop") else not v.any()
             for e in examples for k, v in e.items()
             if k.endswith("_drop") or (isinstance(v, np.ndarray)
                                        and v.dtype.kind == "f"
                                        and v.size > 1)]
    return sum(flags), len(flags)


@pytest.mark.parametrize("embed_refs", [False, True])
@pytest.mark.parametrize("stage", [1, 2, 3])
def test_datasets_match_jax(fake_df, stage, embed_refs):  # noqa: F811
    """``fetch`` over (index, epoch) and a ``__getitem__`` sequence on the
    dataset's own stream: byte-identical, dropout included."""
    root, _ = fake_df
    got_ds, want_ds = _datasets(stage, root, embed_refs)
    n = len(got_ds)
    assert n == len(want_ds)
    fetched = []
    for epoch in range(3):
        for i in range(n):
            got = got_ds.fetch(i, epoch)
            _assert_same(got, want_ds.fetch(i, epoch))
            fetched.append(got)
    for i in [0, 1, 1, 0, n - 1, 0, 1, 0]:
        got = got_ds[i]
        _assert_same(got, want_ds[i])
        fetched.append(got)
    # the drop rates took effect somewhere, and not everywhere
    dropped, conditions = _drops(fetched)
    assert 0 < dropped < conditions


def test_batch_iterator_matches_jax(fake_df):  # noqa: F811
    root, _ = fake_df
    got_ds, want_ds = _datasets(2, root, embed_refs=False)
    got = list(tds.batch_iterator(got_ds, 2, seed=3, epochs=3))
    want = list(jds.batch_iterator(want_ds, 2, seed=3, epochs=3))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        _assert_same(g, w)
    small, _ = _datasets(3, root, embed_refs=False)
    with pytest.raises(ValueError, match="no batch can ever be formed"):
        next(tds.batch_iterator(small, 3))


@pytest.mark.parametrize("workers", [0, 2, 4])
@pytest.mark.parametrize("stage", [1, 2])
def test_loader_matches_jax(fake_df, stage, workers):  # noqa: F811
    """Five examples in batches of 2 (drop_last): each epoch reshuffles and
    redraws its dropout; three epochs."""
    root, _ = fake_df
    got_ds, want_ds = _datasets(stage, root, embed_refs=stage == 1)
    got = list(DataLoader(got_ds, 2, num_workers=workers, seed=7, epochs=3))
    want = list(JDataLoader(want_ds, 2, num_workers=0, seed=7, epochs=3))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        _assert_same(g, w)


def test_loader_refusals_and_workers(monkeypatch):
    with pytest.raises(ValueError, match="no batch can ever be formed"):
        DataLoader([], 1)
    assert resolve_num_workers(3) == 3
    monkeypatch.setattr(os, "cpu_count", lambda: 1)
    assert resolve_num_workers(-1) == 0
    monkeypatch.setattr(os, "cpu_count", lambda: 32)
    assert resolve_num_workers(-1) == 8


def test_prefetch_to_device_on_cpu():
    """The same batches in order, as tensors (a tensor passes as it is),
    ``depth`` batches pulled ahead of the consumer."""
    pulled = []

    def gen():
        for i in range(5):
            pulled.append(i)
            yield {"x": np.full((2, 3), i, np.float32),
                   "t": torch.arange(3) + i}

    stream = prefetch_to_device(gen(), "cpu", depth=2)
    first = next(stream)
    assert pulled == [0, 1, 2]
    assert isinstance(first["x"], torch.Tensor)
    assert first["x"].dtype == torch.float32
    assert first["t"].tolist() == [0, 1, 2]
    rest = list(stream)
    assert [int(b["x"][0, 0]) for b in [first] + rest] == [0, 1, 2, 3, 4]
    assert list(prefetch_to_device(iter([]), "cpu")) == []


# --------------------------------------------------------------------------
# the embedding cache
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def caches(fake_df, tmp_path_factory):  # noqa: F811
    """The port's and JAX's caches of one tiny DINOv2 (the same weights, f32
    compute on both sides) over the fixture's images, in f32 and f16."""
    root, _ = fake_df
    params, model = vit_pair(TINY.dino, 11)
    paths = [os.path.join(root, "train_all_png", f"{x}.png")
             for x in ("a", "b", "c", "a")]            # a repeat: unique'd

    def pre(p):
        return clip_preprocess(load_image(p, (32, 32)))

    t_encode = functools.partial(dino_features, model,
                                 compute_dtype=torch.float32)

    def j_encode(px):
        return np.asarray(j_dino_features(params, jnp.asarray(px),
                                          cfg=TINY.dino,
                                          compute_dtype=jnp.float32))

    out = {}
    for dtype in (np.float32, np.float16):
        d = str(tmp_path_factory.mktemp(f"cache_{np.dtype(dtype).name}"))
        out[np.dtype(dtype).name] = (
            d, tcache.build_or_load(d, "port", t_encode, pre, paths,
                                    batch_size=2, store_dtype=dtype),
            jcache.build_or_load(d, "jax", j_encode, pre, paths,
                                 batch_size=2, store_dtype=dtype))
    return out, paths, t_encode, pre


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_cache_matches_jax(caches, dtype):
    out, paths, t_encode, pre = caches
    d, got, want = out[dtype]
    with open(got.index_path) as f, open(want.index_path) as g:
        assert json.load(f) == json.load(g)
    a = np.load(got.data_path)
    b = np.load(want.data_path)
    assert a.dtype == b.dtype == np.dtype(dtype) and a.shape == b.shape
    assert a.shape == (4, 50, TINY.dino.hidden_size)
    # row 0 is the encoder's output on a zero image, not zeros
    zero = t_encode(np.zeros_like(pre(paths[0]))[None])[0].numpy()
    assert np.abs(a[0]).max() > 0
    if dtype == "float32":
        np.testing.assert_allclose(a, b, **TOL)
        np.testing.assert_allclose(a[0], zero, **TOL)
    else:
        # each store is the f16 rounding of its package's f32 rows, and
        # the two agree at the f32 bar widened by one f16 ulp (two values
        # within the bar may round to neighbouring f16 values)
        for cache in (got, want):
            f32 = np.load(os.path.join(
                out["float32"][0], os.path.basename(cache.dir), "data.npy"))
            assert np.array_equal(np.load(cache.data_path),
                                  f32.astype(np.float16))
        a32, b32 = a.astype(np.float32), b.astype(np.float32)
        ulp = np.spacing(np.abs(b)).astype(np.float32)
        assert np.all(np.abs(a32 - b32)
                      <= TOL["atol"] + TOL["rtol"] * np.abs(b32) + ulp)


def test_caches_read_across_packages(caches):
    """The port reads JAX's cache and JAX reads the port's, as the writer
    does; a dropped item reads row 0."""
    out, paths, _, _ = caches
    d, got, want = out["float32"]
    refs = [paths[2], paths[0], paths[1]]
    dropped = np.array([0.0, 1.0, 0.0], np.float32)
    for name in ("port", "jax"):
        t_read = tcache.EmbeddingCache(d, name)
        j_read = jcache.EmbeddingCache(d, name)
        assert t_read.exists() and j_read.exists()
        rows = t_read.lookup(refs, dropped)
        assert rows.dtype == np.float32
        assert np.array_equal(rows, j_read.lookup(refs, dropped))
        data = np.load(t_read.data_path)
        assert np.array_equal(rows[1], data[0])
        assert np.array_equal(rows[0], data[3])   # c: the third unique path
        assert np.array_equal(t_read.lookup(refs), j_read.lookup(refs))
