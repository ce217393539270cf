"""The exact traversal's round size, port against the reference.

Past ``blocks_per_round`` a round of the port's exact traversal doubles
while the rounds before it pruned nothing, and falls back to
``blocks_per_round`` once one prunes; that holds only for batches above 8,
on sources without a ``refine`` hook, after a round verified on the device
engine. The answers and the ``QueryStats`` must not move: on trees large
enough for rounds to grow, the port answers bit for bit as the reference,
which keeps rounds of ``blocks_per_round``, in far fewer engine passes; on
the paths where rounds may not grow, the engine's passes and the stats are
the reference's. A sorted run's blocks are ranges of its entries: a
round that no entry filter thins and that goes to the engine takes its
arena rows as slices of the run's ids, the rows its positions gave, in the
same order and with the same modeled I/O. Everything runs on the CPU (the
port with ``device="cpu"``, whose engine runs the screens' plain versions).
"""
import dataclasses
import importlib
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.core import verify_engine as rve  # noqa: E402
from repro_torch.core import host_screen as phs  # noqa: E402
from repro_torch.core import verify_engine as pve  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from palmbench import judge, reference  # noqa: E402

# the packages re-export the function ``execute`` under the module's name
rex = importlib.import_module("repro.core.execute")
pex = importlib.import_module("repro_torch.core.execute")

# the suite runs several workers on a few cores: one intra-op thread each
torch.set_num_threads(1)

D, K = 64, 5
BLOCK = 64  # entries a block: 512 blocks over 32,768 series
PER_ROUND = 32  # the executors' default blocks_per_round


def _kw(pkg):
    return {"device": "cpu"} if pkg is P else {}


def _engine(pkg):
    return rve.get_engine() if pkg is R else pve.get_engine("cpu")


def _series(n, seed, walk=False):
    """z-normalized white noise (no block prunes) or random walks."""
    x = np.random.default_rng(seed).standard_normal((n, D))
    if walk:
        x = x.cumsum(axis=1)
    x = (x - x.mean(axis=1, keepdims=True)) / x.std(axis=1, keepdims=True)
    return x.astype(np.float32)


def _ctree(pkg, X, materialized=False):
    raw = pkg.RawStore(D, **_kw(pkg))
    ids = raw.append(X)
    scfg = pkg.SummarizationConfig(series_len=D, n_segments=8, card_bits=6)
    ct = pkg.CTree(pkg.CTreeConfig(summarization=scfg, block_size=BLOCK,
                                   materialized=materialized, **_kw(pkg)))
    ct.bulk_build(X, ids)
    return ct, raw


def _count_host_passes(monkeypatch, module, name):
    """Count the executor's host verification passes (the exact screen
    ``name`` of ``module``)."""
    seen = []
    orig = getattr(module, name)

    def spy(Q, data, k):
        seen.append(len(data))
        return orig(Q, data, k)

    monkeypatch.setattr(module, name, spy)
    return seen


def _ask(pkg, tree, Q, **kw):
    """One batch: (d2, ids, stats, engine passes)."""
    eng = _engine(pkg)
    calls0 = eng.stats["calls"]
    ct, raw = tree
    d2, ids, stats = ct.knn_batch(Q, k=K, raw=raw, **kw)
    return d2, ids, stats, eng.stats["calls"] - calls0


@pytest.fixture(scope="module")
def noise_trees():
    X = _series(512 * BLOCK, seed=0)
    return X, _ctree(P, X), _ctree(R, X)


@pytest.mark.parametrize("m", [16, 64])
def test_rounds_grow_where_nothing_prunes(noise_trees, m):
    """(a) white noise: every block verified by both schedules, the same
    answers and stats, in at most 2 + log2(blocks / 32) engine passes."""
    X, ptree, rtree = noise_trees
    Q = _series(m, seed=99)
    pex.reset_rounds()
    pd, pi, pst, pcalls = _ask(P, ptree, Q)
    assert pex.ROUNDS["grown"] > 0
    rd, ri, rst, rcalls = _ask(R, rtree, Q)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_array_equal(pd, rd)
    assert vars(pst) == vars(rst)
    assert pst.entries_verified == len(X)  # nothing pruned, nothing skipped
    blocks = len(X) // BLOCK
    assert rcalls >= blocks // PER_ROUND
    assert pcalls <= 2 + math.ceil(math.log2(blocks / PER_ROUND))
    nd, ni, nst, ncalls = _ask(P, ptree, Q, backend="numpy")
    np.testing.assert_array_equal(pi, ni)
    np.testing.assert_array_equal(pd, nd)
    assert ncalls == 0


def test_rounds_fall_back_once_a_round_prunes(monkeypatch):
    """(b) random walks, on which blocks prune: the same answers and
    ``blocks_visited`` as the reference, and after a grown round that
    pruned, the next round is ``blocks_per_round`` blocks again."""
    X, Q = _series(1024 * BLOCK, seed=0, walk=True), _series(16, 99, walk=True)
    ptree, rtree = _ctree(P, X), _ctree(R, X)
    rounds = []  # blocks of each device pass
    orig = pex._device_screen

    def spy(Q, ops, trows, k, *, exact):
        rounds.append(trows.size // BLOCK)
        return orig(Q, ops, trows, k, exact=exact)

    monkeypatch.setattr(pex, "_device_screen", spy)
    pex.reset_rounds()
    pd, pi, pst, pcalls = _ask(P, ptree, Q)
    rd, ri, rst, rcalls = _ask(R, rtree, Q)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_array_equal(pd, rd)
    assert pst.blocks_visited == rst.blocks_visited
    assert pst.blocks_pruned == rst.blocks_pruned
    assert pst.blocks_pruned > 0
    assert pst.entries_verified >= rst.entries_verified  # extra, never less
    assert pcalls == len(rounds) < rcalls
    grown = [i for i, b in enumerate(rounds) if b > PER_ROUND]
    assert pex.ROUNDS["grown"] == len(grown) > 0
    # a reset: a grown round followed by one of blocks_per_round
    assert any(rounds[i + 1] == PER_ROUND for i in grown if i + 1 < len(rounds))


@pytest.mark.parametrize("floors", ["engine", "none"])
@pytest.mark.parametrize("m", [1, 8])
def test_small_batches_keep_the_reference_schedule(noise_trees, monkeypatch, m,
                                                   floors):
    """(c) batches of 8 or fewer: one block, then 2, 4, ... up to
    ``blocks_per_round``, pass for pass the reference's; also with the
    engine's size floors lowered in both packages, so that every round of
    the small batch is verified on the device engine."""
    _, ptree, rtree = noise_trees
    Q = _series(m, seed=7)
    if floors == "none":
        for engine in (pve, rve):
            monkeypatch.setattr(engine, "MIN_DEVICE_BATCH", 1)
            monkeypatch.setattr(engine, "MIN_DEVICE_CANDIDATES", 1)
    phost = _count_host_passes(monkeypatch, phs, "screen_topk_exact")
    rhost = _count_host_passes(monkeypatch, rex, "_screen_topk_exact")
    pex.reset_rounds()
    pd, pi, pst, pcalls = _ask(P, ptree, Q)
    rd, ri, rst, rcalls = _ask(R, rtree, Q)
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_array_equal(pd, rd)
    assert vars(pst) == vars(rst)
    assert (pcalls, phost) == (rcalls, rhost)
    assert pcalls > 0 if floors == "none" else len(phost) > 0
    assert pex.ROUNDS["grown"] == 0 and pex.ROUNDS["rounds"] >= len(phost)


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
def test_host_backends_keep_the_reference_schedule(noise_trees, monkeypatch,
                                                   backend):
    """(c) the host backends fetch each round's rows: rounds stay at
    ``blocks_per_round``, pass for pass the reference's (``numpy``)."""
    X, ptree, rtree = noise_trees
    Q = _series(16, seed=11)
    pex.reset_rounds()
    pd, pi, pst, pcalls = _ask(P, ptree, Q, backend=backend)
    assert pcalls == 0 and pex.ROUNDS["grown"] == 0
    assert pex.ROUNDS["rounds"] >= len(X) // BLOCK // PER_ROUND
    if backend == "numpy":
        phost = _count_host_passes(monkeypatch, phs, "screen_topk_exact")
        rhost = _count_host_passes(monkeypatch, rex, "_screen_topk_exact")
        _ask(P, ptree, Q, backend=backend)
        rd, ri, rst, _ = _ask(R, rtree, Q, backend=backend)
        np.testing.assert_array_equal(pi, ri)
        np.testing.assert_array_equal(pd, rd)
        assert vars(pst) == vars(rst)
        assert phost == rhost


def test_refining_sources_keep_the_reference_schedule():
    """(c) ADS+ ``adaptive``: its query-time splits follow the rounds, so
    rounds stay at ``blocks_per_round`` — the same engine passes, stats,
    splits and modeled I/O as the reference's."""
    rng = np.random.default_rng(4)
    X = rng.standard_normal((24_000, D)).astype(np.float32).cumsum(axis=1)
    Q = rng.standard_normal((16, D)).astype(np.float32).cumsum(axis=1)
    out = []
    pex.reset_rounds()
    for pkg in (P, R):
        scfg = pkg.SummarizationConfig(series_len=D, n_segments=8, card_bits=6)
        raw = pkg.RawStore(D, **_kw(pkg))
        ids = raw.append(X)
        ads = pkg.ADSIndex(pkg.ADSConfig(summarization=scfg, leaf_size=256,
                                         mode="adaptive", query_leaf_size=64,
                                         **_kw(pkg)))
        ads.insert_batch(X, ids)
        eng = _engine(pkg)
        calls0 = eng.stats["calls"]
        d2, gids, stats = ads.knn_batch(Q, k=K, raw=raw)
        out.append((d2, gids, vars(stats), eng.stats["calls"] - calls0,
                    ads.n_splits, vars(ads.disk.stats)))
    (pd, pi, *pcounts), (rd, ri, *rcounts) = out
    np.testing.assert_array_equal(pi, ri)
    np.testing.assert_array_equal(pd, rd)
    assert pcounts == rcounts
    assert pcounts[1] > 0 and pcounts[2] > 0  # device passes, query-time splits
    assert pex.ROUNDS["grown"] == 0 and pex.ROUNDS["rounds"] > 2


def test_stream_window_batch_with_a_grown_run_answers_as_the_reference():
    """(d) a BTP stream whose largest run holds far more than 64 blocks:
    its window batch grows that run's rounds and answers as the
    benchmark's plain reference (float64), id for id, within the stream
    cells' limits."""
    batch, batches, window = 2_000, 24, (3, 23)
    X = _series(batch * batches, seed=5)
    Q = _series(16, seed=6)
    scfg = P.SummarizationConfig(series_len=D, n_segments=8, card_bits=6)
    idx = P.StreamingIndex(P.StreamConfig(
        scheme="BTP", summarization=scfg, buffer_entries=1024,
        growth_factor=4, block_size=BLOCK, ingest="sync", screen_dtype="f32",
        device="cpu"))
    try:
        for b in range(batches):
            idx.ingest(X[b * batch:(b + 1) * batch], np.full(batch, b, np.int64))
        pex.reset_rounds()
        d2, ids, _ = idx.window_knn_batch(Q, *window, k=K)
    finally:
        idx.close()
    assert pex.ROUNDS["grown"] > 0
    a, z = window[0] * batch, (window[1] + 1) * batch
    Xt = torch.from_numpy(X)
    ref_d, ref_i = reference.exact_topk(Q, [(a, Xt[a:z])], K)
    m = len(Q)
    r = judge.readings(d2, ids, ref_d, ref_i, reference.true_d2(Q, ids, Xt),
                       np.full(m, a), np.full(m, z))
    assert r["bad_ids"] == 0 and r["dist_gap"] <= 4e-7 and r["id_gap"] <= 4e-7, r
    np.testing.assert_array_equal(ids, ref_i)



# ---------------------------------------------------------------------------
# a sorted run's blocks as ranges: a round's arena rows are slices
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ranged_trees():
    """Noise trees of 512 blocks (no block prunes) over the same series,
    non-materialized and materialized, in both packages; the last block is
    short, so a slice of it runs to the run's end."""
    X = _series(512 * BLOCK - 17, seed=2)
    return X, {mat: (_ctree(P, X, mat), _ctree(R, X, mat))
               for mat in (False, True)}


def _disks(tree):
    ct, raw = tree
    return (ct.disk, raw.disk)


def _every_round_on_the_engine(monkeypatch):
    """Lower the engine's candidate floor in both packages, so that the
    seed round, a few blocks of 64 entries, reaches the engine too."""
    for engine in (pve, rve):
        monkeypatch.setattr(engine, "MIN_DEVICE_CANDIDATES", 1)


def _listed(monkeypatch):
    """Plan the port's sorted runs with one position list a block, as
    before their blocks became ranges (and ``index_read`` took the
    positions)."""
    orig = P.SortedRun.plan_exact

    def plan_exact(self, Q, **kw):
        src = orig(self, Q, **kw)
        read = src.ops.index_read
        ops = dataclasses.replace(
            src.ops, index_read=None if read is None else lambda p: read(p.size))
        return P.BlockSource(ops=ops, lb=src.lb,
                             blocks=[src.blocks.take(np.array([b]))
                                     for b in range(len(src.blocks))])

    monkeypatch.setattr(P.SortedRun, "plan_exact", plan_exact)


def _traced_batch(tree, Q, keep_log, **kw):
    """One port batch with fresh disks: answers, stats, each engine pass's
    arena rows, the engine's h2d bytes, the rounds and the disks' counters
    and logs."""
    for disk in _disks(tree):
        disk.reset()
        disk.keep_log = keep_log
    passes = []
    orig = pex._device_screen

    def spy(Q, ops, trows, k, *, exact):
        passes.append(np.array(trows, copy=True))
        return orig(Q, ops, trows, k, exact=exact)

    ct, raw = tree
    ct.plan(Q, tier="exact", raw=raw).sources[0].ops.device_view()  # uploaded
    eng = _engine(P)
    h2d0 = eng.stats["h2d_bytes"]
    pex.reset_rounds()
    pex._device_screen = spy
    try:
        if kw:
            (d2, ids), stats = pex.execute(ct.plan(Q, tier="exact", raw=raw), Q,
                                           K, **kw)
        else:
            d2, ids, stats, _ = _ask(P, tree, Q)
    finally:
        pex._device_screen = orig
    disks = [(vars(d.stats), d.heatmap(), d.heatmap(7)) for d in _disks(tree)]
    return (d2, ids, vars(stats), passes, eng.stats["h2d_bytes"] - h2d0,
            dict(pex.ROUNDS), disks)


@pytest.mark.parametrize("keep_log", [False, True])
@pytest.mark.parametrize("m", [9, 64])
@pytest.mark.parametrize("materialized", [False, True])
def test_ranged_rounds_take_the_rows_positions_gave(ranged_trees, monkeypatch,
                                                    materialized, m, keep_log):
    """Rounds that grow, every one of them ranged: each engine pass gets the
    rows ``ids[concat(positions)]`` gave (a materialized run: the
    positions), in order, with the same h2d bytes, stats and modeled I/O
    (counters and heat maps, with and without the log) as the same
    schedule over position lists; the answers and ``QueryStats`` are the
    reference's bit for bit."""
    X, trees = ranged_trees
    ptree, rtree = trees[materialized]
    Q = _series(m, seed=31 + m)
    _every_round_on_the_engine(monkeypatch)
    got = _traced_batch(ptree, Q, keep_log)
    rounds = got[5]
    assert rounds["ranged"] == rounds["rounds"] > 0 and rounds["grown"] > 0
    _listed(monkeypatch)
    want = _traced_batch(ptree, Q, keep_log)
    assert want[5] == dict(rounds, ranged=0)
    assert len(got[3]) == len(want[3]) == rounds["rounds"]
    for a, b in zip(got[3], want[3]):
        np.testing.assert_array_equal(a, b)
    assert got[4] == want[4] > 0  # h2d bytes
    assert got[6] == want[6]  # the disks' counters and heat maps
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    rd, ri, rst, _ = _ask(R, rtree, Q)
    np.testing.assert_array_equal(got[1], ri)
    np.testing.assert_array_equal(got[0], rd)
    assert got[2] == vars(rst)
    assert got[2]["entries_verified"] == len(X)


@pytest.mark.parametrize("keep_log", [False, True])
@pytest.mark.parametrize("m", [9, 64])
@pytest.mark.parametrize("materialized", [False, True])
def test_ranged_rounds_account_the_reference_io(ranged_trees, monkeypatch,
                                                materialized, m, keep_log):
    """On the reference's own schedule (one round past the seed, which no
    growth changes), ranged rounds answer and account as the reference:
    the same answers, ``QueryStats``, and disk counters and heat maps with
    the log on and off."""
    X, trees = ranged_trees
    ptree, rtree = trees[materialized]
    Q = _series(m, seed=47 + m)
    _every_round_on_the_engine(monkeypatch)
    per_round = len(X) // BLOCK + 1  # every block in one round
    got = _traced_batch(ptree, Q, keep_log, blocks_per_round=per_round)
    assert got[5] == {"rounds": 2, "grown": 0, "ranged": 2}
    for disk in _disks(rtree):
        disk.reset()
        disk.keep_log = keep_log
    ct, raw = rtree
    (rd, ri), rst = rex.execute(ct.plan(Q, tier="exact", raw=raw), Q, K,
                                blocks_per_round=per_round)
    np.testing.assert_array_equal(got[1], ri)
    np.testing.assert_array_equal(got[0], rd)
    assert got[2] == vars(rst)
    assert got[6] == [(vars(d.stats), d.heatmap(), d.heatmap(7))
                      for d in _disks(rtree)]


def _stream_window(pkg):
    """A BTP stream's windowed batch (its runs carry timestamps)."""
    batch, batches, window = 2_000, 12, (3, 10)
    X = _series(batch * batches, seed=8)
    scfg = pkg.SummarizationConfig(series_len=D, n_segments=8, card_bits=6)
    idx = pkg.StreamingIndex(pkg.StreamConfig(
        scheme="BTP", summarization=scfg, buffer_entries=1024,
        growth_factor=4, block_size=BLOCK, ingest="sync", screen_dtype="f32",
        **_kw(pkg)))
    try:
        for b in range(batches):
            idx.ingest(X[b * batch:(b + 1) * batch], np.full(batch, b, np.int64))
        d2, ids, stats = idx.window_knn_batch(_series(16, seed=9), *window, k=K)
    finally:
        idx.close()
    return d2, ids, vars(stats)


def _adsplus(pkg):
    """ADS+ ``adaptive``: position lists, split by ``refine``."""
    rng = np.random.default_rng(4)
    X = rng.standard_normal((24_000, D)).astype(np.float32).cumsum(axis=1)
    Q = rng.standard_normal((16, D)).astype(np.float32).cumsum(axis=1)
    scfg = pkg.SummarizationConfig(series_len=D, n_segments=8, card_bits=6)
    raw = pkg.RawStore(D, **_kw(pkg))
    ids = raw.append(X)
    ads = pkg.ADSIndex(pkg.ADSConfig(summarization=scfg, leaf_size=256,
                                     mode="adaptive", query_leaf_size=64,
                                     **_kw(pkg)))
    ads.insert_batch(X, ids)
    d2, gids, stats = ads.knn_batch(Q, k=K, raw=raw)
    assert ads.n_splits > 0
    return d2, gids, vars(stats)


@pytest.mark.parametrize("route", ["window", "m8", "m1", "numpy", "kernel",
                                   "adsplus"])
def test_other_routes_take_no_slices(ranged_trees, monkeypatch, route):
    """Where an entry filter applies (a window over runs with timestamps;
    the MINDIST screen of batches of 8 or fewer, here with the engine's
    floors lowered so their rounds reach the device), where the rows go
    through the host (``numpy``, ``kernel``), and on ADS+'s position lists
    split by ``refine``, no round is ranged, and the answers are the
    reference's."""
    if route == "window":
        pex.reset_rounds()
        got = _stream_window(P)
        assert pex.ROUNDS["rounds"] > 0
        want = _stream_window(R)
    elif route == "adsplus":
        pex.reset_rounds()
        got = _adsplus(P)
        assert pex.ROUNDS["rounds"] > 2
        want = _adsplus(R)
    else:
        _, trees = ranged_trees
        ptree, rtree = trees[False]
        kw = {}
        if route in ("numpy", "kernel"):
            Q = _series(16, seed=13)
            kw = {"backend": route}
        else:
            Q = _series(int(route[1:]), seed=13)
            for engine in (pve, rve):
                monkeypatch.setattr(engine, "MIN_DEVICE_BATCH", 1)
                monkeypatch.setattr(engine, "MIN_DEVICE_CANDIDATES", 1)
        pex.reset_rounds()
        pd, pi, pst, pcalls = _ask(P, ptree, Q, **kw)
        assert pex.ROUNDS["rounds"] > 0
        assert pcalls == 0 if kw else pcalls > 0
        got = (pd, pi, vars(pst))
        rd, ri, rst, _ = _ask(R, rtree, Q, **({} if route == "kernel" else kw))
        want = (rd, ri, vars(rst))
    assert pex.ROUNDS["ranged"] == 0
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0], want[0])
    assert got[2] == want[2]
