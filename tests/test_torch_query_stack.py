"""The port's host query stack against the reference: summaries, sortable
keys, the plan executor's states and stats, on the plans of the reference's
executor and batch-query suites. Everything runs on the CPU (the port with
``device="cpu"``); inputs are made with numpy.
"""
import importlib

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.core import sortable as rsort  # noqa: E402
from repro.core import summarization as rsum  # noqa: E402
from repro_torch.core import sortable as psort  # noqa: E402
from repro_torch.core import summarization as psum  # noqa: E402

# the packages re-export the function ``execute`` under the module's name
rex = importlib.import_module("repro.core.execute")
pex = importlib.import_module("repro_torch.core.execute")

# the suite runs several workers on a few cores: one intra-op thread each
torch.set_num_threads(1)

D = 64
CFGS = [(64, 8, 6), (128, 16, 8), (96, 12, 3), (32, 4, 4)]


def _data(n=3000, seed=0, d=D):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)).astype(np.float32).cumsum(axis=1)


def _queries(m=12, seed=99):
    return _data(m, seed)


def _cfgs(n, w, c):
    return (R.SummarizationConfig(series_len=n, n_segments=w, card_bits=c),
            P.SummarizationConfig(series_len=n, n_segments=w, card_bits=c))


# ---------------------------------------------------------------------------
# summaries and sortable keys
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,w,c", CFGS)
def test_summaries_equal_reference(n, w, c):
    rc, pc = _cfgs(n, w, c)
    X = _data(500, seed=n + w, d=n)
    np.testing.assert_array_equal(psum.breakpoints(c), rsum.breakpoints(c))
    p_paa, r_paa = psum.paa(X, pc), rsum.paa(X, rc)
    np.testing.assert_array_equal(p_paa, r_paa)
    np.testing.assert_array_equal(psum.sax_from_paa(p_paa, pc),
                                  rsum.sax_from_paa(r_paa, rc))
    sym = psum.sax(X, pc)
    for a, b in zip(psum.sax_region(sym, pc), rsum.sax_region(sym, rc)):
        np.testing.assert_array_equal(a, b)
    zc = P.SummarizationConfig(series_len=n, n_segments=w, card_bits=c,
                               znorm=True)
    zr = R.SummarizationConfig(series_len=n, n_segments=w, card_bits=c,
                               znorm=True)
    np.testing.assert_array_equal(psum.sax(X, zc), rsum.sax(X, zr))


@pytest.mark.parametrize("n,w,c", CFGS)
def test_sortable_keys_equal_reference_as_uint32(n, w, c):
    rc, pc = _cfgs(n, w, c)
    rng = np.random.default_rng(w * c)
    sym = rng.integers(0, 1 << c, (700, w)).astype(np.int32)
    sym[:5] = (1 << c) - 1  # all-ones symbols set the top key bits
    pk, rk = psort.interleave(sym, pc), rsort.interleave(sym, rc)
    assert pk.dtype == np.uint32
    np.testing.assert_array_equal(pk, rk)
    if pc.key_bits >= 32:
        assert (pk[:5, 0] >= 2**31).all()  # keys beyond int32's range survive
    np.testing.assert_array_equal(psort.deinterleave(pk, pc), sym)
    np.testing.assert_array_equal(psort.lexsort_keys(pk), rsort.lexsort_keys(rk))
    skeys = pk[psort.lexsort_keys(pk)]
    q = rng.integers(0, 1 << c, (40, w)).astype(np.int32)
    qk = psort.interleave(q, pc)
    qk[:3] = skeys[[0, 350, -1]]  # exact hits and both ends
    np.testing.assert_array_equal(psort.searchsorted_keys_batch(skeys, qk),
                                  rsort.searchsorted_keys_batch(skeys, qk))
    for i in range(5):
        assert (psort.searchsorted_keys(skeys, qk[i])
                == rsort.searchsorted_keys(skeys, qk[i]))


# ---------------------------------------------------------------------------
# host helpers of the executor
# ---------------------------------------------------------------------------
def test_screens_and_state_merge_equal_reference(rng):
    Q = _queries(9, seed=3)
    X = _data(700, seed=4)
    for fn in ("_screen_topk_exact", "_screen_topk_slack"):
        pv, pi = getattr(pex, fn)(Q, X, 6)
        rv, ri = getattr(rex, fn)(Q, X, 6)
        np.testing.assert_array_equal(pv, rv)
        np.testing.assert_array_equal(pi, ri)
    vals, ids = pex.empty_topk_state(9, 4)
    nv = rng.standard_normal((9, 6)).astype(np.float32)
    ni = rng.permutation(54).reshape(9, 6).astype(np.int64)
    a = pex.merge_topk_state(vals, ids, nv, ni)
    b = rex.merge_topk_state(vals, ids, nv, ni)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert pex.recall_at_k(a[1], b[1]) == 1.0


# ---------------------------------------------------------------------------
# execute: identical states and stats on the reference suites' plans
# ---------------------------------------------------------------------------
def _pair_ctree(X, mat, block_size=256):
    rc, pc = _cfgs(D, 8, 6)
    out = []
    for pkg, cfg, kw in ((R, rc, {}), (P, pc, {"device": "cpu"})):
        raw = pkg.RawStore(D, **kw)
        ids = raw.append(X)
        ct = pkg.CTree(pkg.CTreeConfig(summarization=cfg, block_size=block_size,
                                       materialized=mat, **kw))
        ct.bulk_build(X, ids)
        out.append((ct, raw))
    return out


def _same(a, b):
    (av, ag, ast), (bv, bg, bst) = a, b
    np.testing.assert_array_equal(av, bv)
    np.testing.assert_array_equal(ag, bg)
    assert vars(ast) == vars(bst)


@pytest.mark.parametrize("backend", ["device", "numpy"])
@pytest.mark.parametrize("mat", [False, True])
@pytest.mark.parametrize("k", [1, 7])
def test_ctree_exact_and_approx_equal_reference(mat, k, backend):
    X, Q = _data(), _queries()
    (rct, rraw), (pct, praw) = _pair_ctree(X, mat)
    _same(pct.knn_batch(Q, k=k, raw=praw, backend=backend),
          rct.knn_batch(Q, k=k, raw=rraw, backend=backend))
    for nb in (1, 3):
        _same(pct.knn_approx_batch(Q, k=k, n_blocks=nb, raw=praw, backend=backend),
              rct.knn_approx_batch(Q, k=k, n_blocks=nb, raw=rraw, backend=backend))
    # scalar wrappers are batch-of-1 plans on both sides
    assert pct.knn_exact(Q[0], k=k, raw=praw)[0] == rct.knn_exact(Q[0], k=k, raw=rraw)[0]
    assert pct.knn_approx(Q[1], k=k, raw=praw)[0] == rct.knn_approx(Q[1], k=k, raw=rraw)[0]


def test_ctree_gap_inserts_and_windows_equal_reference():
    X, Q = _data(2000, seed=5), _queries(10, seed=6)
    rc, pc = _cfgs(D, 8, 6)
    got = []
    for pkg, cfg, kw in ((R, rc, {}), (P, pc, {"device": "cpu"})):
        raw = pkg.RawStore(D, **kw)
        ct = pkg.CTree(pkg.CTreeConfig(summarization=cfg, block_size=256,
                                       fill_factor=0.75, **kw))
        ts = np.arange(2000, dtype=np.int64)
        ct.bulk_build(X[:1500], raw.append(X[:1500]), ts=ts[:1500])
        ct.insert(X[1500:], raw.append(X[1500:]), ts=ts[1500:])  # pending gaps
        got.append([ct.knn_batch(Q, k=5, raw=raw, window=w)
                    for w in (None, (100, 1800), (1600, 1999))])
    for a, b in zip(*got):
        _same(a, b)


def test_clsm_dense_and_block_sources_equal_reference():
    X, Q = _data(5000, seed=3), _queries(24, seed=7)
    rc, pc = _cfgs(D, 8, 6)
    got = []
    for pkg, cfg, kw in ((R, rc, {}), (P, pc, {"device": "cpu"})):
        raw = pkg.RawStore(D, **kw)
        lsm = pkg.CLSM(pkg.CLSMConfig(summarization=cfg, buffer_entries=1024,
                                      growth_factor=3, block_size=256,
                                      materialized=True, **kw))
        lsm.insert(X, raw.append(X), np.arange(len(X), dtype=np.int64))
        assert lsm.registry.current().buffer_n > 0  # a dense tail is planned
        got.append([lsm.knn_batch(Q, k=7, raw=raw, window=(500, 4900)),
                    lsm.knn_approx_batch(Q, k=7, n_blocks=2, raw=raw),
                    lsm.knn_batch(Q[:4], k=3, raw=raw, time_skip=False)])
        got[-1].append(lsm.n_runs)
    assert got[0][-1] == got[1][-1]
    for a, b in zip(got[0][:-1], got[1][:-1]):
        _same(a, b)


def _range_fixture(pkg, n=8192, m=64, seed=17):
    """The reference's range-routing fixture: one device-ready span group
    plus many 1-query groups below the batch floor, fetches counted."""
    ve = rve if pkg is R else pve
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, D)).astype(np.float32).cumsum(axis=1)
    xsq = np.einsum("ij,ij->i", X.astype(np.float64), X.astype(np.float64))
    Q = rng.standard_normal((m, D)).astype(np.float32).cumsum(axis=1)
    big = ve.MIN_DEVICE_CANDIDATES
    spans = np.empty((m, 2), np.int64)
    nbig = ve.MIN_DEVICE_BATCH + 3
    spans[:nbig] = (0, big)
    for i in range(nbig, m):
        lo = big + ((i - nbig) * 96) % (n - big - 256)
        spans[i] = (lo, lo + 192)
    calls = {"fetch": 0, "rows": 0, "acct": 0, "acct_rows": 0}

    def fetch(pos):
        calls["fetch"] += 1
        calls["rows"] += int(pos.size)
        return X[pos]

    def fetch_account(pos):
        calls["acct"] += 1
        calls["acct_rows"] += int(pos.size)

    view = (ve.get_engine() if pkg is R else ve.get_engine("cpu")).build_view(X)
    ops = pkg.SourceOps(ids=np.arange(n, dtype=np.int64), fetch=fetch,
                        norms2=lambda pos: xsq[pos], device_view=lambda: view,
                        table_rows=lambda pos: pos,
                        table_ids=lambda rows: rows.astype(np.int64),
                        fetch_account=fetch_account)
    return Q, pkg.RangeSource(ops=ops, spans=spans, logical_blocks=1), calls


from repro.core import verify_engine as rve  # noqa: E402
from repro_torch.core import verify_engine as pve  # noqa: E402


def test_range_routing_equals_reference():
    out = {}
    for name, pkg in (("ref", R), ("port", P)):
        Q, src, calls = _range_fixture(pkg)
        (vals, gids), st = pkg.execute(pkg.QueryPlan(m=Q.shape[0], sources=[src]),
                                       Q, k=5, backend="device")
        out[name] = (vals, gids, st, calls)
    _same(out["port"][:3], out["ref"][:3])
    assert out["port"][3] == out["ref"][3]
    assert out["port"][3]["fetch"] == 1 and out["port"][3]["acct"] == 1


def test_unported_backends_raise_and_unknown_names_error():
    X, Q = _data(600), _queries(3)
    (_, _), (pct, praw) = _pair_ctree(X, True)
    with pytest.raises(NotImplementedError, match="Queue 2 item 3"):
        pct.knn_batch(Q, k=3, raw=praw, backend="kernel")
    with pytest.raises(NotImplementedError, match="Queue 2 items 4-5"):
        pct.knn_approx_batch(Q, k=3, raw=praw, backend="kernel")
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        pct.knn_batch(Q, k=3, raw=praw, shard="mesh")
    with pytest.raises(ValueError, match="backend"):
        pct.knn_batch(Q, k=3, raw=praw, backend="cuda")
    with pytest.raises(ValueError, match="shard"):
        pex.execute(P.QueryPlan(m=3, sources=[]), Q, 3, shard="bogus")


# ---------------------------------------------------------------------------
# the modeled I/O and its access heat map
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("keep_log", [True, False])
def test_fetch_accounting_and_heat_map_equal_reference(keep_log):
    """The port logs a fetch's per-row page touches as one bulk record; its
    counters and heat map must be those of the reference's per-row reads."""
    rng = np.random.default_rng(4)
    X = _data(5000, seed=4)
    stores = (R.RawStore(D), P.RawStore(D, device="cpu"))
    for raw in stores:
        raw.disk.keep_log = keep_log
        raw.append(X[:3000])
        raw.append(X[3000:])
    for size in (0, 1, 17, 900, 4000):
        ids = rng.choice(5000, size, replace=False)
        for raw in stores:
            raw.fetch(ids)
            raw.account_fetch(ids[::-1])
            with raw.disk.unaccounted():
                raw.fetch(ids)
    for raw in stores:
        raw.scan()
    rdisk, pdisk = (raw.disk for raw in stores)
    assert vars(pdisk.stats) == vars(rdisk.stats)
    for n_bins, max_page in ((64, None), (7, None), (64, 100), (1, None)):
        assert (pdisk.heatmap(n_bins, max_page)
                == rdisk.heatmap(n_bins, max_page))
    assert P.render_heatmap(pdisk.heatmap()) == R.render_heatmap(rdisk.heatmap())
