"""The port's ``backend="kernel"`` query path against the reference's.

Every verification pass of this backend fetches its rows on the host and
runs one ``topk_ed`` over them (a slack-8 slate, then the f64 re-rank); the
approximate tier also summarizes its query keys with ``paa`` -> ``sax_pack``.
On the CPU (``device="cpu"``) the port runs the kernels' plain versions and
the reference its Pallas kernels in interpret mode. The final ``(d2, ids)``
and the ``QueryStats`` must be bitwise the reference's, on ``CTree``,
``CLSM`` and ``StreamingIndex`` windows (ADS+ in ``test_torch_adsplus.py``),
and the ids those of the numpy backend.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

# the suite runs several workers on a few cores: one intra-op thread each
torch.set_num_threads(1)

D = 64


def _walks(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, D)).astype(np.float32).cumsum(axis=1)


def _kw(pkg):
    return {"device": "cpu"} if pkg is P else {}


def _scfg(pkg):
    return pkg.SummarizationConfig(series_len=D, n_segments=8, card_bits=6)


def _same(a, b):
    (av, ag, ast), (bv, bg, bst) = a, b
    np.testing.assert_array_equal(ag, bg)
    np.testing.assert_array_equal(av, bv)
    assert vars(ast) == vars(bst)


def _ctree(pkg, X, mat=True, block_size=256):
    raw = pkg.RawStore(D, **_kw(pkg))
    ids = raw.append(X)
    ct = pkg.CTree(pkg.CTreeConfig(summarization=_scfg(pkg), block_size=block_size,
                                   materialized=mat, **_kw(pkg)))
    ct.bulk_build(X, ids)
    return ct, raw


@pytest.mark.parametrize("mat", [True, False])
def test_ctree_exact_kernel_backend_equals_reference(mat):
    """test_batch_query.py's kernel parity case, port against reference."""
    X, Q = _walks(1500), _walks(6, seed=99)
    (pct, praw), (rct, rraw) = _ctree(P, X, mat), _ctree(R, X, mat)
    ops.reset_launches()
    got = pct.knn_batch(Q, k=5, raw=praw, backend="kernel")
    _same(got, rct.knn_batch(Q, k=5, raw=rraw, backend="kernel"))
    v_np, g_np, _ = pct.knn_batch(Q, k=5, raw=praw, backend="numpy")
    np.testing.assert_array_equal(got[1], g_np)
    np.testing.assert_allclose(got[0], v_np, rtol=1e-6)
    assert ops.LAUNCHES["topk_ed"] == 0  # CPU tensors: the plain version


@pytest.mark.parametrize("n_blocks", [1, 2, 8])
def test_ctree_approx_kernel_backend_equals_reference(n_blocks):
    """test_approx_tier.py's kernel parity case: the query keys come from
    the summarize front, the spans' passes from topk_ed."""
    X, Q = _walks(2000), _walks(8, seed=11)
    (pct, praw), (rct, rraw) = _ctree(P, X), _ctree(R, X)
    got = pct.knn_approx_batch(Q, k=5, n_blocks=n_blocks, raw=praw,
                               backend="kernel")
    _same(got, rct.knn_approx_batch(Q, k=5, n_blocks=n_blocks, raw=rraw,
                                    backend="kernel"))
    v_np, g_np, _ = pct.knn_approx_batch(Q, k=5, n_blocks=n_blocks, raw=praw,
                                         backend="numpy")
    np.testing.assert_array_equal(got[1], g_np)
    np.testing.assert_allclose(got[0], v_np, rtol=1e-5)


def test_query_keys_of_the_kernel_path_equal_reference():
    X, Q = _walks(800), _walks(30, seed=3)
    (pct, _), (rct, _) = _ctree(P, X), _ctree(R, X)
    pk = pct.run._query_keys_batch(Q, "kernel")
    assert pk.dtype == np.uint32
    np.testing.assert_array_equal(pk, rct.run._query_keys_batch(Q, "kernel"))
    np.testing.assert_array_equal(pk, pct.run._query_keys_batch(Q, "numpy"))


def test_clsm_kernel_backend_equals_reference():
    """Dense buffer, block and span sources of a CLSM, windowed."""
    X, Q = _walks(5000, seed=3), _walks(12, seed=7)
    got = []
    for pkg in (P, R):
        raw = pkg.RawStore(D, **_kw(pkg))
        lsm = pkg.CLSM(pkg.CLSMConfig(summarization=_scfg(pkg), buffer_entries=1024,
                                      growth_factor=3, block_size=256,
                                      materialized=True, **_kw(pkg)))
        lsm.insert(X, raw.append(X), np.arange(len(X), dtype=np.int64))
        got.append([lsm.knn_batch(Q, k=7, raw=raw, window=(500, 4900),
                                  backend="kernel"),
                    lsm.knn_approx_batch(Q, k=7, n_blocks=2, raw=raw,
                                         backend="kernel")])
    for a, b in zip(*got):
        _same(a, b)


@pytest.mark.parametrize("scheme", ["PP", "TP", "BTP"])
def test_streaming_windows_kernel_backend_equal_reference(scheme):
    """A stream's window queries on both tiers, non-materialized runs (the
    rows come from the raw store's host fetch)."""
    out = []
    for pkg in (P, R):
        idx = pkg.StreamingIndex(pkg.StreamConfig(
            scheme=scheme, summarization=_scfg(pkg), buffer_entries=512,
            growth_factor=3, block_size=128, materialized=False, **_kw(pkg)))
        rng = np.random.default_rng(1)
        for b in range(8):
            idx.ingest(rng.standard_normal((300, D)).astype(np.float32).cumsum(axis=1),
                       np.full(300, b, np.int64))
        Q = _walks(10, seed=5)
        res = []
        for t0, t1 in ((1, 6), (0, 7), (5, 7)):
            res.append(idx.window_knn_batch(Q, t0, t1, k=4, backend="kernel"))
            res.append(idx.window_knn_approx_batch(Q, t0, t1, k=4, n_blocks=2,
                                                   backend="kernel"))
        res.append(idx.knn_batch(Q, k=4, backend="kernel"))
        out.append(res)
        if pkg is P:  # the exact tier answers as the numpy backend does
            _, ids, _ = idx.window_knn_batch(Q, 1, 6, k=4, backend="numpy")
            np.testing.assert_array_equal(res[0][1], ids)
    for a, b in zip(*out):
        _same(a, b)


def test_kernel_backend_needs_the_source_device():
    """The executor never guesses a device: a source without one refuses
    the kernel backend instead of quietly running on the CPU."""
    X, Q = _walks(300), _walks(3)
    ops_ = P.SourceOps(ids=np.arange(300), fetch=lambda p: X[p])
    src = P.BlockSource(ops=ops_, lb=np.zeros((3, 1), np.float32),
                        blocks=[np.arange(300)])
    with pytest.raises(ValueError, match="device"):
        P.execute(P.QueryPlan(m=3, sources=[src]), Q, 3, backend="kernel")
    ops_.device = torch.device("cpu")
    (vals, ids), _ = P.execute(P.QueryPlan(m=3, sources=[src]), Q, 3,
                               backend="kernel")
    bf = np.argsort(((Q[:, None, :].astype(np.float64) - X[None]) ** 2).sum(-1),
                    axis=1, kind="stable")[:, :3]
    np.testing.assert_array_equal(ids, bf)
