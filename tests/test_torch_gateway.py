"""The port's dynamic-batching gateway against the reference's.

The same submissions go to the reference ``Gateway`` over a reference
``StreamingIndex`` and to the port's ``Gateway`` over the port's index
(``device="cpu"``), both built from the same seeded numpy series. Batches
form deterministically: ``max_batch`` is the count submitted at once and the
deadline is long, so each batch flushes full, never on a timer. Every
response must carry the same ids and f32 d2 bit for bit and the same
provenance, and equal the port's direct ``knn_batch``,
``window_knn_batch`` and ``knn_approx_batch`` calls at the tier and
``n_blocks`` it names. Then each check of ``tests/test_gateway.py`` runs on
the port; the concurrent-client check asserts invariants only, never how
batches happened to form.
"""
import dataclasses
import sys
import threading
import time

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.core import gateway as pgateway  # noqa: E402
from repro_torch.core.gateway import ladder  # noqa: E402
from repro_torch.core.verify_engine import get_engine  # noqa: E402

# the suite runs several workers on a few cores: one intra-op thread each
torch.set_num_threads(1)

LEN = 64
LONG_DEADLINE_MS = 60_000.0  # batches flush full, never on the timer


def _series(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, LEN)).astype(np.float32).cumsum(axis=1)


def _index(pkg=P, n_batches=8, bsz=300, **kw):
    if pkg is P:
        kw["device"] = "cpu"
    idx = pkg.StreamingIndex(pkg.StreamConfig(
        scheme="BTP", summarization=pkg.SummarizationConfig(
            series_len=LEN, n_segments=8, card_bits=6),
        buffer_entries=512, growth_factor=3, block_size=128, **kw))
    for b in range(n_batches):
        idx.ingest(_series(bsz, 100 + b), np.full(bsz, b, np.int64))
    return idx


@pytest.fixture(scope="module")
def idx():
    return _index()


@pytest.fixture(scope="module")
def pair():
    """A reference and a port index over the same 4,800 series: enough
    that sub-batches of 9 queries or more pass the engine's candidate floor
    and screen on the device path (the plain versions, here)."""
    return _index(R, n_batches=12, bsz=400), _index(P, n_batches=12, bsz=400)


def _gateway(idx, **kw):
    kw.setdefault("deadline_ms", 3.0)
    kw.setdefault("max_batch", 16)
    kw.setdefault("k", 5)
    return pgateway.Gateway(idx, pgateway.GatewayConfig(**kw))


# ------------------------------------------------ parity with the reference
def _mixed(n):
    """The serve loop's tenant kinds, in a fixed order: plain exact,
    windowed exact, recall-targeted, windowed recall-targeted, conflicting
    targets, strict recall."""
    kinds = [{}, {"window": (2, 6)}, {"target_recall": 0.9},
             {"target_recall": 0.9, "window": (3, 9)},
             {"target_recall": 0.95, "latency_budget_ms": 0.05},
             {"target_recall": 1.0}]
    return [kinds[i % len(kinds)] for i in range(n)]


# name -> (gateway config, batch size B, submissions): the submissions go in
# rounds of B, each submitted at once (B = max_batch, so it fills one batch);
# a round starts after the last answer of the one before, so the shed state
# and the tuner it sees are settled
CASES = {
    "exact-12": (dict(), 12, [{}] * 12),
    "rung-1": (dict(), 1, [{}] * 2),
    "rung-5": (dict(), 5, [{}] * 5),
    "rung-13": (dict(), 13, [{}] * 13),
    "mixed-tiers": (dict(), 32, _mixed(64)),
    "windowed": (dict(), 20, [{"window": (0, 4)}] * 10
                 + [{"window": (5, 9), "target_recall": 0.8}] * 10),
    "slo-shed": (dict(slo_p99_ms=0.001, min_shed_samples=8), 16,
                 [{}] * 16 + _mixed(16) + [{}] * 8
                 + [{"target_recall": 1.0}] * 8),
    "k-mix": (dict(k=3), 22, [{"k": 1}] * 9 + [{"k": 7}] * 9 + [{}] * 4),
    "autotune-forced": (dict(autotune=True, forced=("approx", 4)), 18,
                        _mixed(36)),
    "autotune": (dict(autotune=True), 36, _mixed(36)),
}
# cases with a sub-batch that reaches the engine's screen
SCREENED = ("exact-12", "rung-13", "mixed-tiers", "windowed", "k-mix",
            "slo-shed", "autotune")


def _serve_case(pkg, index, cfg, B, kinds):
    cfg = dict(cfg)
    forced = cfg.pop("forced", None)
    if cfg.get("autotune"):
        tkw = {"seed": 3}
        if forced is not None:
            tkw["forced"] = pkg.Knobs(*forced)
        cfg["autotune_cfg"] = pkg.AutoTunerConfig(**tkw)
    # no shedding unless the case asks for it: the rolling p99 is a clock
    # reading, which two packages do not share
    gw = pkg.Gateway(index, pkg.GatewayConfig(
        deadline_ms=LONG_DEADLINE_MS, max_batch=B,
        **{"k": 5, "slo_p99_ms": 1e9, **cfg}))
    out = []
    try:
        for r in range(0, len(kinds), B):
            Q = _series(B, 500 + r)
            tix = [gw.submit(q, **kw) for q, kw in zip(Q, kinds[r:r + B])]
            out += [(q, kw, t.result(timeout=120))
                    for q, kw, t in zip(Q, kinds[r:r + B], tix)]
    finally:
        gw.close()
    return out


def _direct(index, q, kw, r):
    """The port's direct call at the tier and n_blocks a response names."""
    k = kw.get("k", r.ids.shape[0])
    Q = q[None]
    win = kw.get("window")
    if r.tier_served == "exact":
        if win is None:
            return index.knn_batch(Q, k=k)[:2]
        return index.window_knn_batch(Q, win[0], win[1], k=k)[:2]
    nb = max(r.n_blocks, 1)
    if win is None:
        return index.knn_approx_batch(Q, k=k, n_blocks=nb)[:2]
    return index.window_knn_approx_batch(Q, win[0], win[1], k=k,
                                         n_blocks=nb)[:2]


@pytest.mark.parametrize("name", sorted(CASES))
def test_answers_equal_the_reference_gateway(name, pair):
    """Bit for bit the reference gateway's ids, f32 d2 and provenance, and
    the port's direct call at the served tier."""
    ridx, pidx = pair
    cfg, B, kinds = CASES[name]
    assert len(kinds) % B == 0
    calls = get_engine("cpu").stats["calls"]
    got = _serve_case(P, pidx, cfg, B, kinds)
    if name in SCREENED:
        assert get_engine("cpu").stats["calls"] > calls
    want = _serve_case(R, ridx, cfg, B, kinds)
    assert len(got) == len(want) == len(kinds)
    fields = ("tier_served", "n_blocks", "shed", "conflict", "batch_size",
              "padded_to")
    for (q, kw, pr), (_, _, rr) in zip(got, want):
        assert pr.vals.dtype == rr.vals.dtype and pr.ids.dtype == rr.ids.dtype
        np.testing.assert_array_equal(pr.ids, rr.ids)
        np.testing.assert_array_equal(pr.vals.view(np.uint8),
                                      rr.vals.view(np.uint8))
        assert [getattr(pr, f) for f in fields] == \
            [getattr(rr, f) for f in fields], kw
        vals, ids = _direct(pidx, q, kw, pr)
        np.testing.assert_array_equal(pr.ids, ids[0])
        np.testing.assert_array_equal(pr.vals, vals[0])
    tiers = {r.tier_served for _, _, r in got}
    if name in ("mixed-tiers", "slo-shed"):
        assert tiers == {"exact", "approx"}
    if name == "slo-shed":
        assert any(r.shed and not r.conflict for _, _, r in got)


def test_ladder_equals_the_reference():
    from repro.core.gateway import ladder as rladder

    for m in (1, 8, 9, 16, 24, 33, 64):
        assert ladder(m) == rladder(m)
    assert ladder(64) == (8, 16, 32, 64)
    assert ladder(16) == (8, 16)
    assert ladder(8) == (8,)
    assert ladder(24) == (8, 16, 24)


def test_prewarm_on_a_cpu_index_never_asks_for_the_card(idx, monkeypatch):
    """``prewarm`` takes the engine of the index's own device: a CPU index
    registers its signatures on the CPU engine and never resolves CUDA
    (which raises without a card)."""
    asked = []

    def spy(device="cuda"):
        asked.append(str(device))
        return get_engine(device)

    monkeypatch.setattr(pgateway, "get_engine", spy)
    gw = _gateway(idx)
    try:
        before = get_engine("cpu").stats["traces"]
        n = gw.prewarm([300 * (b + 1) for b in range(8)])
        assert asked == ["cpu"]
        assert get_engine("cpu").stats["traces"] == before + n
    finally:
        gw.close()


def test_engine_errors_reach_every_ticket(idx, monkeypatch):
    """An error in an engine pass resolves every ticket of its batch with
    that error; nothing swallows it, and the dispatcher serves on."""
    gw = _gateway(idx, deadline_ms=LONG_DEADLINE_MS, max_batch=4)
    boom = RuntimeError("engine pass failed")
    real = pgateway.Gateway._query_group

    def failing(self, tier, *a, **kw):
        if tier == "approx":
            raise boom
        return real(self, tier, *a, **kw)

    monkeypatch.setattr(pgateway.Gateway, "_query_group", failing)
    try:
        Q = _series(8, 12)
        tix = [gw.submit(q, target_recall=0.9) for q in Q[:4]]
        for t in tix:
            with pytest.raises(RuntimeError, match="engine pass failed"):
                t.result(timeout=60)
        ok = [gw.submit(q) for q in Q[4:]]
        assert all(t.result(timeout=60).tier_served == "exact" for t in ok)
    finally:
        gw.close()


def test_shadow_work_errors_reach_resolved_tickets(idx, monkeypatch):
    """Shadow work runs after the tickets resolve; an error there resolves
    them again, so a second ``result()`` raises it."""
    from repro_torch.core.autotune import AutoTunerConfig

    gw = _gateway(idx, deadline_ms=LONG_DEADLINE_MS, max_batch=4,
                  autotune=True, autotune_cfg=AutoTunerConfig(seed=0))
    done = threading.Event()

    def failing(self, *a, **kw):
        done.wait(60)
        raise RuntimeError("shadow work failed")

    monkeypatch.setattr(pgateway.Gateway, "_shadow_work", failing)
    try:
        tix = [gw.submit(q, target_recall=0.9) for q in _series(4, 13)]
        first = [t.result(timeout=60) for t in tix]
        assert all(r.ids.shape == (5,) for r in first)
        done.set()
    finally:
        gw.close()
    for t in tix:
        with pytest.raises(RuntimeError, match="shadow work failed"):
            t.result(timeout=60)


# ------------------------------------- the reference's checks, on the port
def test_max_batch_cannot_exceed_engine_chunk(idx):
    with pytest.raises(ValueError):
        pgateway.Gateway(idx, pgateway.GatewayConfig(max_batch=128))


def test_single_request_deadline_flush(idx):
    gw = _gateway(idx, deadline_ms=5.0)
    try:
        r = gw.submit(_series(1, 7)[0]).result(timeout=30)
        assert r.batch_size == 1 and r.padded_to == 8
        assert r.tier_served == "exact" and not r.shed
        assert r.ids.shape == (5,)
        st = gw.snapshot_stats()
        assert st["deadline_flushes"] == 1 and st["full_flushes"] == 0
        assert st["batch_hist"] == {1: 1}
    finally:
        gw.close()


def test_full_rung_flushes_without_waiting_deadline(idx):
    gw = _gateway(idx, deadline_ms=2_000.0, max_batch=8)
    try:
        t0 = time.perf_counter()
        resps = [t.result(timeout=60) for t in
                 [gw.submit(q) for q in _series(8, 8)]]
        assert (time.perf_counter() - t0) < 100.0
        assert all(r.batch_size == 8 and r.padded_to == 8 for r in resps)
        assert gw.snapshot_stats()["full_flushes"] >= 1
    finally:
        gw.close()


@pytest.mark.parametrize("m", [1, 3, 5, 9, 13])
def test_padding_never_leaks_parity_all_rungs(idx, m):
    """A partial batch pads to its rung; answers equal a direct call with
    only the real queries."""
    gw = _gateway(idx, deadline_ms=LONG_DEADLINE_MS, max_batch=m)
    try:
        Q = _series(m, 200 + m)
        resps = [t.result(timeout=60) for t in [gw.submit(q) for q in Q]]
        vals, gids, _ = idx.knn_batch(Q, k=5)
        for i, r in enumerate(resps):
            assert r.padded_to == max(8, 1 << (m - 1).bit_length())
            assert np.array_equal(r.ids, gids[i])
            assert np.array_equal(r.vals, vals[i])
    finally:
        gw.close()


def test_mixed_tier_batch_splits_and_matches_direct_calls(idx):
    gw = _gateway(idx, deadline_ms=LONG_DEADLINE_MS, max_batch=12)
    try:
        Q = _series(12, 31)
        tix = [gw.submit(Q[i]) for i in range(4)]
        tix += [gw.submit(Q[i], target_recall=0.9) for i in range(4, 8)]
        tix += [gw.submit(Q[i], window=(2, 6)) for i in range(8, 12)]
        resps = [t.result(timeout=60) for t in tix]
        assert len({r.epoch for r in resps}) == 1
        assert all(r.batch_size == 12 for r in resps)
        ev, ei, _ = idx.knn_batch(Q[:4], k=5)
        av, ai, _ = idx.knn_approx_batch(Q[4:8], k=5,
                                         n_blocks=resps[4].n_blocks)
        wv, wi, _ = idx.window_knn_batch(Q[8:12], 2, 6, k=5)
        for i in range(4):
            for r, v, ids, tier in ((resps[i], ev, ei, "exact"),
                                    (resps[4 + i], av, ai, "approx"),
                                    (resps[8 + i], wv, wi, "exact")):
                assert r.tier_served == tier
                assert np.array_equal(r.ids, ids[i])
                assert np.array_equal(r.vals, v[i])
    finally:
        gw.close()


def test_deterministic_mixed_tenant_split(idx):
    def run_once():
        gw = _gateway(idx, deadline_ms=LONG_DEADLINE_MS, max_batch=8)
        try:
            Q = _series(8, 77)
            tix = [gw.submit(Q[i], target_recall=1.0) for i in range(4)]
            tix += [gw.submit(Q[i], target_recall=0.9, latency_budget_ms=0.05)
                    for i in range(4, 8)]
            return [(r.tier_served, r.n_blocks, r.shed, r.conflict,
                     tuple(r.ids)) for r in (t.result(timeout=60) for t in tix)]
        finally:
            gw.close()

    a, b = run_once(), run_once()
    assert a == b
    assert all(t[0] == "exact" and not t[2] and not t[3] for t in a[:4])
    assert all(t[0] == "approx" and t[2] and t[3] for t in a[4:])


def test_conflict_propagates_into_shed_decision(idx):
    gw = _gateway(idx, slo_p99_ms=1e9)
    try:
        r = gw.submit(_series(1, 5)[0], target_recall=0.95,
                      latency_budget_ms=0.05).result(timeout=30)
        assert r.conflict and r.shed and r.tier_served == "approx"
        ok = gw.submit(_series(1, 6)[0], target_recall=0.9).result(timeout=30)
        assert not ok.conflict and not ok.shed
    finally:
        gw.close()


def test_slo_shedding_engages_and_spares_strict_requests(idx):
    gw = _gateway(idx, slo_p99_ms=0.001, min_shed_samples=8,
                  deadline_ms=1.0, max_batch=8)
    try:
        Q = _series(40, 50)
        for i in range(16):
            gw.submit(Q[i]).result(timeout=30)
        assert gw.snapshot_stats()["shedding"]
        shed = gw.submit(Q[20]).result(timeout=30)
        assert shed.shed and shed.tier_served == "approx"
        assert shed.n_blocks == gw.cfg.shed_n_blocks
        strict = gw.submit(Q[21], target_recall=1.0).result(timeout=30)
        assert not strict.shed and strict.tier_served == "exact"
        _, ai, _ = idx.knn_approx_batch(Q[20:21], k=5, n_blocks=shed.n_blocks)
        assert np.array_equal(shed.ids, ai[0])
        st = gw.snapshot_stats()
        assert st["shed_transitions"] >= 1 and st["shed_served"] >= 1
    finally:
        gw.close()


def test_shed_hysteresis_recovers():
    idx2 = _index(n_batches=2, bsz=100)
    gw = _gateway(idx2, slo_p99_ms=50.0, min_shed_samples=4)
    try:
        with gw._cond:
            gw._lat_ms.extend([100.0] * 8)
            gw._update_shed_locked()
            assert gw._shedding
            gw._lat_ms.extend([1.0] * gw.cfg.lat_window)
            gw._update_shed_locked()
            assert not gw._shedding
            assert gw.stats["shed_transitions"] == 2
    finally:
        gw.close()
        idx2.close()


def test_reset_slo_window_clears_shed_state():
    idx2 = _index(n_batches=2, bsz=100)
    gw = _gateway(idx2, slo_p99_ms=50.0, min_shed_samples=4)
    try:
        with gw._cond:
            gw._lat_ms.extend([100.0] * 8)
            gw._update_shed_locked()
            assert gw._shedding
        gw.reset_slo_window()
        st = gw.snapshot_stats()
        assert not st["shedding"] and st["p99_ms"] == 0.0
        assert st["shed_transitions"] == 2
        gw.reset_slo_window()
        assert gw.snapshot_stats()["shed_transitions"] == 2
    finally:
        gw.close()
        idx2.close()


@pytest.mark.parametrize("outcome", ["served", "failed"])
def test_reset_slo_window_waits_for_the_last_batch(idx, monkeypatch, outcome):
    """A batch's latencies join the SLO window after its shadow work, which
    runs after its tickets resolve. A reset made as soon as the last ticket
    resolves waits for that batch's accounting (or its failure), so the
    window it leaves is empty and stays empty; it raises after its
    timeout. (The reference resets at once and is refilled.)"""
    from repro_torch.core.autotune import AutoTunerConfig

    gw = _gateway(idx, deadline_ms=LONG_DEADLINE_MS, max_batch=4,
                  autotune=True, autotune_cfg=AutoTunerConfig(seed=0))
    release = threading.Event()
    real = pgateway.Gateway._shadow_work

    def held(self, *a, **kw):
        release.wait(60)
        if outcome == "failed":
            raise RuntimeError("shadow work failed")
        return real(self, *a, **kw)

    monkeypatch.setattr(pgateway.Gateway, "_shadow_work", held)
    try:
        tix = [gw.submit(q, target_recall=0.9) for q in _series(4, 14)]
        for t in tix:
            t.result(timeout=60)
        assert gw.snapshot().served == 0  # the batch is in its shadow work
        with pytest.raises(TimeoutError):
            gw.reset_slo_window(timeout=0.05)
        threading.Timer(0.2, release.set).start()
        gw.reset_slo_window(timeout=60)
        st = gw.snapshot()
        assert st.p99_ms == 0.0 and not st.shedding
        assert st.served == (4 if outcome == "served" else 0)
    finally:
        release.set()
        gw.close()


def test_queue_wait_provenance_and_bounded_queue(idx):
    gw = _gateway(idx, deadline_ms=10.0)
    try:
        r = gw.submit(_series(1, 9)[0]).result(timeout=30)
        assert 0.0 <= r.queue_wait_ms <= r.latency_ms
    finally:
        gw.close()
    with pytest.raises(RuntimeError):
        gw.submit(_series(1, 9)[0])


def test_concurrent_clients_with_background_ingest_invariants():
    """Concurrent single-query clients against a background-ingest stream,
    with a short thread switch interval. Live: every answer is a sorted,
    full slate of ingested ids; each client's epochs never go back; an
    exact answer windowed over batches ingested before the clients started
    equals the direct call (later batches lie outside the window); an
    approximate windowed answer lies inside its window; an exact
    whole-history answer's d2 are its ids' own and its k-th is at or below
    the brute force's over the rows every epoch held. The counters add up.
    Quiesced (ingest drained, one full batch): answers equal the direct
    calls bit for bit."""
    bsz, pre, total = 250, 4, 10
    idx = _index(n_batches=pre, bsz=bsz, ingest="async")
    assert idx.drain(timeout=120)
    gw = _gateway(idx, deadline_ms=4.0, max_batch=16)
    errs, results = [], {}

    def ingester():
        try:
            for b in range(pre, total):
                idx.ingest(_series(bsz, 300 + b), np.full(bsz, b, np.int64))
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errs.append(e)

    def client(cid):
        try:
            rng = np.random.default_rng(1000 + cid)
            out = []
            for j in range(6):
                q = rng.standard_normal(LEN).astype(np.float32).cumsum()
                kw = {}
                if j % 3 == 1:
                    kw["target_recall"] = 0.9
                if j % 2 == 1:
                    kw["window"] = (0, pre - 1)
                out.append((q, kw, gw.submit(q, **kw).result(timeout=120)))
            results[cid] = out
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errs.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=ingester)] + [
            threading.Thread(target=client, args=(c,)) for c in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    try:
        assert not errs, errs
        assert sorted(results) == list(range(6))
        X = idx.raw.scan()
        assert X.shape[0] == total * bsz
        held = X[: pre * bsz].astype(np.float64)  # in every epoch
        for out in results.values():
            epochs = [r.epoch for _, _, r in out]
            assert epochs == sorted(epochs)
            for q, kw, r in out:
                assert r.vals.shape == (5,) and r.ids.shape == (5,)
                assert (np.diff(r.vals) >= 0).all()
                assert ((r.ids >= 0) & (r.ids < X.shape[0])).all()
                win = kw.get("window")
                if win is not None and r.tier_served == "exact":
                    vals, ids, _ = idx.window_knn_batch(q[None], *win, k=5)
                    assert np.array_equal(r.ids, ids[0])
                    assert np.array_equal(r.vals, vals[0])
                elif win is not None:
                    assert (r.ids < pre * bsz).all()
                elif r.tier_served == "exact":
                    d2 = ((X[r.ids].astype(np.float64) - q) ** 2).sum(1)
                    np.testing.assert_allclose(r.vals, d2, rtol=1e-5,
                                               atol=1e-3)
                    floor = np.sort(((held - q) ** 2).sum(1))[4]
                    assert r.vals[-1] <= floor * (1 + 1e-5) + 1e-3
        st = gw.snapshot_stats()
        assert st["submitted"] == st["served"] == 36
        assert st["batches"] == st["deadline_flushes"] + st["full_flushes"]
        assert sum(s * c for s, c in st["batch_hist"].items()) == 36
    finally:
        gw.close()
    assert idx.drain(timeout=120)
    gw = _gateway(idx, deadline_ms=LONG_DEADLINE_MS, max_batch=10)
    try:
        Q = _series(10, 999)
        tix = [gw.submit(q) for q in Q[:5]]
        tix += [gw.submit(q, target_recall=0.9) for q in Q[5:]]
        resps = [t.result(timeout=60) for t in tix]
        assert len({r.epoch for r in resps}) == 1
        ev, ei, _ = idx.knn_batch(Q[:5], k=5)
        av, ai, _ = idx.knn_approx_batch(Q[5:], k=5,
                                         n_blocks=resps[5].n_blocks)
        for i in range(5):
            assert np.array_equal(resps[i].ids, ei[i])
            assert np.array_equal(resps[i].vals, ev[i])
            assert np.array_equal(resps[5 + i].ids, ai[i])
            assert np.array_equal(resps[5 + i].vals, av[i])
    finally:
        gw.close()
        idx.close()


def test_prewarmed_gateway_serves_with_zero_retraces():
    # whole batches reach the engine's screen: 9 queries or more, and at
    # this size passes of 1,024 candidates or more
    idx2 = _index(n_batches=12, bsz=400)
    gw = _gateway(idx2, deadline_ms=200.0, max_batch=16)
    engine = get_engine("cpu")
    try:
        gw.prewarm([400 * (b + 1) for b in range(12)])
        before = engine.stats["traces"]
        calls = engine.stats["calls"]
        for m in (1, 4, 8, 11, 16):
            for t in [gw.submit(q) for q in _series(m, 600 + m)]:
                t.result(timeout=60)
        assert engine.stats["traces"] == before
        assert engine.stats["calls"] > calls  # the engine's screen served
        assert sum(engine.stats["batch_hist"].values()) > 0
    finally:
        gw.close()
        idx2.close()


def test_engine_batch_hist_is_monotonic(idx):
    engine = get_engine("cpu")
    h0 = dict(engine.stats["batch_hist"])
    idx.knn_batch(_series(16, 42), k=5)
    h1 = dict(engine.stats["batch_hist"])
    assert all(h1.get(kk, 0) >= v for kk, v in h0.items())
    assert sum(h1.values()) >= sum(h0.values())


def test_snapshot_is_typed_and_dict_view_matches(idx):
    gw = _gateway(idx)
    try:
        for i in range(5):
            gw.submit(_series(1, 40 + i)[0]).result(timeout=60)
        snap = gw.snapshot()
        assert isinstance(snap, P.GatewayStats)
        assert dataclasses.asdict(gw.snapshot()) == gw.snapshot_stats()
        assert snap.served == 5 and snap.submitted == 5
        assert not snap.autotune and snap.tuner_decisions == 0
        with pytest.raises(dataclasses.FrozenInstanceError):
            snap.served = 0
        keys = set(gw.snapshot_stats())
        assert {"served", "submitted", "batches", "queue_depth", "shedding",
                "p50_ms", "p99_ms", "batch_hist", "autotune"} <= keys
        rkeys = {f.name for f in dataclasses.fields(R.GatewayStats)}
        assert keys == rkeys
    finally:
        gw.close()
