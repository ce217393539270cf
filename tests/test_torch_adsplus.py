"""The port's ADS+ index against the reference's.

The same series and queries (made with numpy) go into a reference and a
port ``ADSIndex`` (the port with ``device="cpu"``): top-down inserts with
their modeled I/O, the exact tier's leaf traversal with ADS+'s query-time
splits (``mode="adaptive"``), and the approximate tier's leaf groups, under
every backend. Answers, ``QueryStats``, splits, modeled I/O and the
engines' device-pass counts must be those of the reference; the f32, bf16
and int8 arenas run through the port's screen+select plain versions.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.core import verify_engine as rve  # noqa: E402
from repro_torch.core import verify_engine as pve  # noqa: E402

# the suite runs several workers on a few cores: one intra-op thread each
torch.set_num_threads(1)

D = 64


def _data(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, D)).astype(np.float32).cumsum(axis=1)


def _queries(m=10, seed=99):
    return _data(m, seed)


def _kw(pkg):
    return {"device": "cpu"} if pkg is P else {}


def _engine(pkg):
    return rve.get_engine() if pkg is R else pve.get_engine("cpu")


def _build(pkg, X, *, ts=None, dtype=None, **cfg):
    scfg = pkg.SummarizationConfig(series_len=D, n_segments=8, card_bits=6)
    raw = pkg.RawStore(D, screen_dtype=dtype, **_kw(pkg))
    ids = raw.append(X)
    ads = pkg.ADSIndex(pkg.ADSConfig(summarization=scfg, screen_dtype=dtype,
                                     **cfg, **_kw(pkg)))
    ads.insert_batch(X, ids, ts=ts)
    return ads, raw


def _same(a, b):
    (av, ag, ast), (bv, bg, bst) = a, b
    np.testing.assert_array_equal(ag, bg)
    np.testing.assert_array_equal(av, bv)
    assert vars(ast) == vars(bst)


def _run(pkg, X, Q, backend, dtype, mode):
    ads, raw = _build(pkg, X, dtype=dtype, leaf_size=2048, mode=mode,
                      query_leaf_size=256)
    eng = _engine(pkg)
    calls0, fb0 = eng.stats["calls"], eng.stats["fallbacks"]
    out = [ads.knn_batch(Q, k=5, raw=raw, backend=backend),
           ads.knn_approx_batch(Q, k=5, raw=raw, backend=backend),
           ads.knn_batch(Q[:3], k=2, raw=raw, backend=backend)]
    counts = (ads.n_splits, eng.stats["calls"] - calls0,
              eng.stats["fallbacks"] - fb0, vars(ads.disk.stats))
    return out, counts


@pytest.mark.parametrize("backend", ["device", "numpy"])
@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("mode", ["full", "adaptive"])
def test_ads_equals_reference(mode, dtype, backend):
    """The reference's quantized ADS+ case (test_screen_dtype.py): 4,000
    series, leaves of 2,048 split at query time down to 256."""
    X, Q = _data(4000, seed=4), _queries(16, seed=9)
    got, gcounts = _run(P, X, Q, backend, dtype, mode)
    want, wcounts = _run(R, X, Q, backend, dtype, mode)
    for a, b in zip(got, want):
        _same(a, b)
    assert gcounts == wcounts
    if mode == "adaptive":
        assert gcounts[0] > 0  # the refine hook split leaves at query time
    if backend == "device":
        assert gcounts[1] > 0  # the device screen served passes


@pytest.mark.parametrize("mode", ["full", "adaptive"])
@pytest.mark.parametrize("k", [1, 7])
def test_ads_exact_tier_equals_reference(mode, k):
    """The reference's batched exact ADS+ cases (test_plan_executor.py),
    plus the scalar wrapper (test_indexes.py)."""
    X, Q = _data(), _queries()
    got, want = (_build(pkg, X, leaf_size=256, mode=mode, query_leaf_size=64)
                 for pkg in (P, R))
    _same(got[0].knn_batch(Q, k=k, raw=got[1]), want[0].knn_batch(Q, k=k, raw=want[1]))
    assert (got[0].knn_exact(Q[0], k=5, raw=got[1])[0]
            == want[0].knn_exact(Q[0], k=5, raw=want[1])[0])
    assert got[0].knn_approx(Q[1], k=5, raw=got[1])[0] == \
        want[0].knn_approx(Q[1], k=5, raw=want[1])[0]
    assert got[0].n_splits == want[0].n_splits


@pytest.mark.parametrize("mode", ["full", "adaptive"])
def test_ads_kernel_backend_equals_reference(mode):
    """``backend="kernel"`` (one ``topk_ed`` pass per verification, the plain
    version on the CPU): bitwise the reference's kernel answers, and the
    numpy backend's (test_plan_executor.py's kernel parity case)."""
    X, Q = _data(1500), _queries(5)
    got, want = (_build(pkg, X, leaf_size=256, mode=mode, query_leaf_size=64)
                 for pkg in (P, R))
    for fn, kw in (("knn_batch", {}), ("knn_approx_batch", {})):
        pk = getattr(got[0], fn)(Q, k=5, raw=got[1], backend="kernel", **kw)
        _same(pk, getattr(want[0], fn)(Q, k=5, raw=want[1], backend="kernel", **kw))
        pn = getattr(got[0], fn)(Q, k=5, raw=got[1], backend="numpy", **kw)
        np.testing.assert_array_equal(pk[1], pn[1])
        np.testing.assert_allclose(pk[0], pn[0], rtol=1e-6)


def test_ads_windows_and_inserts_equal_reference():
    """Window filtering over timestamps (test_plan_executor.py) and the
    top-down insert's random I/O (test_indexes.py), in two insert batches."""
    X = _data(2000, seed=5)
    T = np.repeat(np.arange(20), 100).astype(np.int64)
    Q = _queries(6, seed=7)
    out = []
    for pkg in (P, R):
        scfg = pkg.SummarizationConfig(series_len=D, n_segments=8, card_bits=6)
        raw = pkg.RawStore(D, **_kw(pkg))
        ads = pkg.ADSIndex(pkg.ADSConfig(summarization=scfg, leaf_size=128,
                                         **_kw(pkg)))
        ads.insert_batch(X[:1200], raw.append(X[:1200]), ts=T[:1200])
        ads.insert_batch(X[1200:], raw.append(X[1200:]), ts=T[1200:])
        res = [ads.knn_batch(Q, k=3, raw=raw, window=w) for w in ((4, 9), None)]
        res.append(ads.knn_approx_batch(Q, k=3, raw=raw, window=(4, 9)))
        out.append((res, ads.n, ads.n_splits, ads.index_bytes(),
                    vars(ads.disk.stats)))
    for a, b in zip(out[0][0], out[1][0]):
        _same(a, b)
    assert out[0][1:] == out[1][1:]
    assert out[0][-1]["rand_ops"] > 2000  # at least one random page op an insert
    mask = (T >= 4) & (T <= 9)
    assert all(mask[g] for g in out[0][0][0][1].ravel() if g >= 0)


def test_ads_empty_index_and_empty_batch():
    for pkg in (P, R):
        scfg = pkg.SummarizationConfig(series_len=D, n_segments=8, card_bits=6)
        ads = pkg.ADSIndex(pkg.ADSConfig(summarization=scfg, **_kw(pkg)))
        vals, gids, _ = ads.knn_batch(_queries(3), k=4)
        assert (vals == np.inf).all() and (gids == -1).all()
        vals, gids, _ = ads.knn_approx_batch(_queries(3), k=4, backend="kernel")
        assert (vals == np.inf).all() and (gids == -1).all()
        ads, raw = _build(pkg, _data(200))
        vals, gids, _ = ads.knn_batch(np.zeros((0, D), np.float32), k=4, raw=raw)
        assert vals.shape == (0, 4) and gids.shape == (0, 4)


def test_ads_device_defaults_to_the_card():
    assert P.ADSConfig().device == "cuda"
    ads, _ = _build(P, _data(100))
    assert ads.device.type == "cpu"
