"""The port's verification engine against the reference engine.

Both engines run on the CPU (the port with ``device="cpu"``, so its plain
screen versions; the reference with its XLA twin). Same data, made with
numpy: arenas are built bit for bit alike, ``screen_topk`` returns bitwise
equal (d2, ids) after the f64 re-rank at f32, bf16 and int8, and the
certificate falls back on exactly the same queries.
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

DTYPES = ("f32", "bf16", "int8")
D = 64


def _data(n=6000, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, D)).astype(np.float32).cumsum(axis=1)


def _queries(m=32, seed=99):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((m, D)).astype(np.float32).cumsum(axis=1)


def _adversarial(n, seed=0, offset=3000.0, spread=0.01):
    rng = np.random.default_rng(seed)
    return (offset + spread * rng.standard_normal((n, D))).astype(np.float32)


def _near_duplicates():
    """The reference suite's near-duplicate families (16 copies > k + slack):
    no storage dtype can certify them."""
    rng0 = np.random.default_rng(2)
    base = _adversarial(250, seed=2)
    X = (np.tile(base, (16, 1))
         + 1e-6 * rng0.standard_normal((4000, D))).astype(np.float32)
    rng = np.random.default_rng(1)
    Q = np.stack([X[i] + 0.001 * rng.standard_normal(D).astype(np.float32)
                  for i in range(16)])
    return X, Q


def _cancellation():
    X = _adversarial(4000)
    rng = np.random.default_rng(1)
    Q = np.stack([X[i] + 0.001 * rng.standard_normal(D).astype(np.float32)
                  for i in range(16)])
    return X, Q


def _table_bits(table) -> np.ndarray:
    """An arena table as comparable numpy bits (bf16 as uint16)."""
    if isinstance(table, torch.Tensor):
        if table.dtype == torch.bfloat16:
            return table.view(torch.int16).numpy().view(np.uint16)
        return table.numpy()
    a = np.asarray(table)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def _ported(rview, device="cpu"):
    return pve.view_from_arrays(
        rview.host, rview.mu, _table_bits(rview.table), np.asarray(rview.xn2),
        None if rview.scale is None else np.asarray(rview.scale), rview.n,
        rview.cap, rview.xn2max, rview.dtype, rview.qerr, device=device)


@pytest.fixture
def engines():
    return rve.get_engine(), pve.VerifyEngine(device="cpu")


# ---------------------------------------------------------------------------
# arenas
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
def test_build_view_is_bitwise_the_reference_arena(dtype, engines):
    reng, peng = engines
    X = _data(3000, seed=8)
    rv = reng.build_view(X, dtype=dtype)
    pv = peng.build_view(X, dtype=dtype)
    assert (pv.n, pv.cap, pv.dtype) == (rv.n, rv.cap, rv.dtype)
    np.testing.assert_array_equal(pv.mu, rv.mu)
    np.testing.assert_array_equal(_table_bits(pv.table), _table_bits(rv.table))
    np.testing.assert_array_equal(pv.xn2.numpy(), np.asarray(rv.xn2))
    if dtype == "int8":
        np.testing.assert_array_equal(pv.scale.numpy(), np.asarray(rv.scale))
    else:
        assert pv.scale is None and rv.scale is None
    assert pv.qerr == rv.qerr and pv.xn2max == rv.xn2max
    assert pv.nbytes == rv.nbytes


@pytest.mark.parametrize("dtype", DTYPES)
def test_extend_view_matches_the_reference_extend(dtype, engines):
    reng, peng = engines
    X = _data(3100, seed=8)
    rv = reng.extend_view(reng.build_view(X[:3000], dtype=dtype), X)
    pv = peng.extend_view(peng.build_view(X[:3000], dtype=dtype), X)
    assert (pv.n, pv.cap) == (rv.n, rv.cap) == (3100, 4096)
    n = pv.n
    np.testing.assert_array_equal(_table_bits(pv.table)[:n],
                                  _table_bits(rv.table)[:n])
    np.testing.assert_array_equal(pv.xn2.numpy()[:n], np.asarray(rv.xn2)[:n])
    assert pv.qerr == rv.qerr and pv.xn2max == rv.xn2max
    # unwritten rows, the sentinel among them, stay zero with BIG norms
    assert (pv.xn2.numpy()[n:] == np.float32(1e30)).all()
    assert not _table_bits(pv.table)[n:].any()


@pytest.mark.parametrize("dtype", DTYPES)
def test_view_from_arrays_round_trips(dtype, engines):
    reng, _ = engines
    rv = reng.build_view(_data(1000, seed=3), dtype=dtype)
    pv = _ported(rv)
    np.testing.assert_array_equal(_table_bits(pv.table), _table_bits(rv.table))
    assert pv.table.dtype == pve._SCREEN_DTYPES[dtype]
    assert pv.device == torch.device("cpu")


def test_arena_bytes_and_release_accounting():
    eng = pve.VerifyEngine(device="cpu")
    X = _data(2000, seed=21)
    views = {dt: eng.build_view(X, dtype=dt) for dt in DTYPES}
    assert eng.stats["arena_bytes"] == sum(v.nbytes for v in views.values())
    assert views["f32"].nbytes / views["bf16"].nbytes >= 1.9
    assert views["f32"].nbytes / views["int8"].nbytes >= 3.5
    for v in views.values():
        eng.release_view(v)
    assert eng.stats["arena_bytes"] == 0
    assert eng.stats["released_arenas"] == 3


def test_stats_keys_match_the_reference(engines):
    reng, peng = engines
    assert set(peng.stats) == set(reng.stats)


# ---------------------------------------------------------------------------
# screen_topk: bitwise parity and equal fallbacks on identical arenas
# ---------------------------------------------------------------------------
_SETS = {
    "random_walk": lambda: (_data(6000), _queries(32)),
    "cancellation": _cancellation,
    "near_duplicates": _near_duplicates,
}


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("data", sorted(_SETS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_screen_topk_bitwise_and_same_fallbacks(dtype, data, exact, engines):
    reng, peng = engines
    X, Q = _SETS[data]()
    rv = reng.build_view(X, dtype=dtype)
    pv = _ported(rv)
    rng = np.random.default_rng(7)
    for trows in (np.arange(X.shape[0]),  # full-coverage pass
                  np.sort(rng.choice(X.shape[0], 1500, replace=False))):  # gather
        f0r, f0p = reng.stats["fallbacks"], peng.stats["fallbacks"]
        rd, ri = reng.screen_topk(rv, trows, Q, 5, exact=exact)
        pd, pi = peng.screen_topk(pv, trows, Q, 5, exact=exact)
        np.testing.assert_array_equal(pd, rd)
        np.testing.assert_array_equal(pi, ri)
        assert peng.stats["fallbacks"] - f0p == reng.stats["fallbacks"] - f0r
    if data == "near_duplicates":
        assert peng.stats["fallbacks"] > 0  # the certificate did fire


def test_own_arena_equals_reference_arena_answers(engines):
    """The port's own build_view (not a copy of the reference's) gives the
    same answers: the arenas are bitwise alike."""
    reng, peng = engines
    X, Q = _data(5000, seed=3), _queries(24, seed=7)
    trows = np.arange(0, 5000, 3)
    for dtype in DTYPES:
        rd, ri = reng.screen_topk(reng.build_view(X, dtype=dtype), trows, Q, 7)
        pd, pi = peng.screen_topk(peng.build_view(X, dtype=dtype), trows, Q, 7)
        np.testing.assert_array_equal(pd, rd)
        np.testing.assert_array_equal(pi, ri)


def test_large_batches_chunk_like_the_reference(engines):
    reng, peng = engines
    X, Q = _data(3000, seed=1), _queries(150, seed=2)
    rv = reng.build_view(X)
    pv = _ported(rv)
    calls = peng.stats["calls"]
    trows = np.arange(2000)
    rd, ri = reng.screen_topk(rv, trows, Q, 4)
    pd, pi = peng.screen_topk(pv, trows, Q, 4)
    np.testing.assert_array_equal(pd, rd)
    np.testing.assert_array_equal(pi, ri)
    assert peng.stats["calls"] - calls == 3  # 64 + 64 + 22
    assert peng.stats["batch_hist"] == {64: 2, 32: 1}


# ---------------------------------------------------------------------------
# indexes: device path == reference device path, bitwise
# ---------------------------------------------------------------------------
CFG_R = R.SummarizationConfig(series_len=D, n_segments=8, card_bits=6)
CFG_P = P.SummarizationConfig(series_len=D, n_segments=8, card_bits=6)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mat", [True, False])
def test_ctree_device_answers_equal_reference(mat, dtype):
    X, Q = _data(), _queries()
    rraw = R.RawStore(D, screen_dtype=dtype)
    praw = P.RawStore(D, screen_dtype=dtype, device="cpu")
    rct = R.CTree(R.CTreeConfig(summarization=CFG_R, block_size=512,
                                materialized=mat, screen_dtype=dtype))
    pct = P.CTree(P.CTreeConfig(summarization=CFG_P, block_size=512,
                                materialized=mat, screen_dtype=dtype,
                                device="cpu"))
    rct.bulk_build(X, rraw.append(X))
    pct.bulk_build(X, praw.append(X))
    peng = pve.get_engine("cpu")
    calls = peng.stats["calls"]
    rv, rg, rs = rct.knn_batch(Q, k=10, raw=rraw)
    pv, pg, ps = pct.knn_batch(Q, k=10, raw=praw)
    np.testing.assert_array_equal(pv, rv)
    np.testing.assert_array_equal(pg, rg)
    assert vars(ps) == vars(rs)
    assert peng.stats["calls"] > calls  # the device path served it
    rv, rg, _ = rct.knn_approx_batch(Q, k=10, n_blocks=3, raw=rraw)
    pv, pg, _ = pct.knn_approx_batch(Q, k=10, n_blocks=3, raw=praw)
    np.testing.assert_array_equal(pv, rv)
    np.testing.assert_array_equal(pg, rg)


@pytest.mark.parametrize("dtype", DTYPES)
def test_ill_conditioned_fallbacks_equal_reference(dtype):
    """On the near-duplicate families both engines fall back on the same
    number of queries and answer bitwise alike."""
    X, Q = _near_duplicates()
    out = {}
    for name, pkg, cfg, kw in (("ref", R, CFG_R, {}),
                               ("port", P, CFG_P, {"device": "cpu"})):
        raw = pkg.RawStore(D, screen_dtype=dtype, **kw)
        ct = pkg.CTree(pkg.CTreeConfig(summarization=cfg, block_size=512,
                                       materialized=True, screen_dtype=dtype,
                                       **kw))
        ct.bulk_build(X, raw.append(X))
        eng = rve.get_engine() if name == "ref" else pve.get_engine("cpu")
        fb = eng.stats["fallbacks"]
        vals, gids, _ = ct.knn_batch(Q, k=5, raw=raw)
        out[name] = (vals, gids, eng.stats["fallbacks"] - fb)
    np.testing.assert_array_equal(out["port"][0], out["ref"][0])
    np.testing.assert_array_equal(out["port"][1], out["ref"][1])
    assert out["port"][2] == out["ref"][2] > 0


# ---------------------------------------------------------------------------
# T4: an extend between a pass's padding and its launch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
def test_extend_racing_a_pass_keeps_its_answers(dtype, monkeypatch):
    """A pass pads its gather with the sentinel row. If an in-place extend
    lands after the padding and before the launch, the pass must still
    screen exactly its planned rows: the sentinel is row cap-1, which no
    extend writes (row n, the reference's pad target, becomes real data)."""
    X = _data(3000, seed=8)
    Q = _queries(16, seed=3)
    raw = P.RawStore(D, screen_dtype=dtype, device="cpu")
    raw.append(X)
    eng = pve.get_engine("cpu")
    view0 = raw.device_view()
    trows = np.arange(0, 3000, 2)  # 1500 rows -> a 1536-row gather, 36 pads
    fb0 = eng.stats["fallbacks"]
    want = eng.screen_topk(view0, trows, Q, 5)
    fb_want = eng.stats["fallbacks"] - fb0

    real = pve._screen_pass
    landed = []

    def extend_then_screen(view, rows, xn2, qc, s):
        if not landed:  # the racing ingest: rows that match the queries
            raw.append(np.repeat(Q, 3, axis=0))
            landed.append(raw.device_view())
        return real(view, rows, xn2, qc, s)

    monkeypatch.setattr(pve, "_screen_pass", extend_then_screen)
    got = eng.screen_topk(view0, trows, Q, 5)
    view1 = landed[0]
    assert view1.table is view0.table and view1.n == 3048  # in place
    assert view0.sentinel >= view1.n
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # no spurious certificate failure: the same queries fall back as before
    assert eng.stats["fallbacks"] - fb0 - fb_want == fb_want


def test_arena_extends_in_place_then_rebuilds():
    X = _data(3000, seed=8)
    raw = P.RawStore(D, device="cpu")
    raw.append(X)
    eng = pve.get_engine("cpu")
    view0 = raw.device_view()
    up0 = eng.stats["uploads"]
    raw.append(_data(48, seed=12))
    view1 = raw.device_view()
    assert view1.n == 3048 and view1.cap == view0.cap
    assert view1.table.data_ptr() == view0.table.data_ptr()
    assert eng.stats["uploads"] == up0 + 1
    raw.append(_data(500, seed=14))
    view2 = raw.device_view()
    assert view2.n == 3548 and view2.cap > view0.cap


# ---------------------------------------------------------------------------
# signatures, prewarm, TF32
# ---------------------------------------------------------------------------
def test_prewarm_registers_the_ladder_once():
    eng = pve.VerifyEngine(device="cpu")
    first = eng.prewarm(96, m=16, k=5, caps=[3000])
    assert first > 0 and eng.prewarm(96, m=16, k=5, caps=[3000]) == 0
    assert eng.stats["traces"] == first


def test_steady_state_serving_counts_only_hits():
    rng = np.random.default_rng(21)
    idx = P.StreamingIndex(P.StreamConfig(scheme="BTP", summarization=CFG_P,
                                          buffer_entries=2048, growth_factor=4,
                                          block_size=512, device="cpu"))
    for b in range(6):
        x = rng.standard_normal((1500, D)).astype(np.float32).cumsum(axis=1)
        idx.ingest(x, np.full(1500, b, np.int64))
    eng = pve.get_engine("cpu")
    eng.prewarm(D, m=16, k=5, caps=[idx.raw.n])
    idx.knn_batch(_queries(16, seed=0), k=5)
    traces0, calls0, hits0 = (eng.stats[k] for k in ("traces", "calls", "hits"))
    for b in range(6):
        idx.knn_batch(_queries(16 if b % 2 else 13, seed=100 + b), k=5)
    d_calls = eng.stats["calls"] - calls0
    assert d_calls > 0
    assert eng.stats["traces"] == traces0
    assert eng.stats["hits"] - hits0 == d_calls


def test_tf32_stays_off_through_a_pass():
    eng = pve.VerifyEngine(device="cpu")
    view = eng.build_view(_data(2000, seed=5))
    eng.screen_topk(view, np.arange(2000), _queries(16), 5)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_engine_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pve.VerifyEngine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pve.get_engine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pve.view_from_arrays(np.zeros((1, 4), np.float32), np.zeros(4, np.float32),
                             np.zeros((64, 4), np.float32), np.zeros(64, np.float32),
                             None, 1, 64, 0.0, "f32", 0.0)
