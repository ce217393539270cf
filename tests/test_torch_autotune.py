"""The port's online autotuner against the reference's.

The same seed and the same scripted decide/observe sequence (drawn from a
seeded numpy generator) must give both packages the same decision records,
the same schema-1 trace, the same ``snapshot()`` and the same
``advise_global`` output. Then each check of ``tests/test_autotune.py``
runs on the port, the gateway integration over a ``device="cpu"`` index.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import repro.core.autotune as RA  # noqa: E402
import repro_torch.core.autotune as PA  # noqa: E402
from repro_torch.core.autotune import (  # noqa: E402
    DECISION_SCHEMA, N_BLOCKS_GRID, AutoTuner, AutoTunerConfig, Knobs,
    knob_grid, workload_key,
)
from repro_torch.core.recommender import Scenario, serving_tier  # noqa: E402

# the suite runs several workers on a few cores: one intra-op thread each
torch.set_num_threads(1)

K9 = dict(target_recall=0.9, k=5, batch_rung=16)


def _env(knobs):
    """Synthetic ground truth: approx latency grows with n_blocks, exact
    is expensive; recall follows a curve steeper than the static prior."""
    if knobs.tier == "exact":
        return 9.0, 1.0
    return 0.8 + 0.45 * knobs.n_blocks, min(1.0, 0.82 + 0.05 * knobs.n_blocks)


def _drive(tuner, key, n=250, epoch=0, n_series=10**6, jitter=None):
    for i in range(n):
        d = tuner.decide(key, epoch=epoch, n_series=n_series)
        for kn in filter(None, (d.knobs, d.shadow)):
            lat, rec = _env(kn)
            if jitter is not None:
                lat *= 1.0 + jitter * ((i % 7) - 3) / 10.0
            tuner.observe(key, kn, lat_ms=lat, epoch=epoch, recall=rec)


# ------------------------------------------------- parity with the reference
def _script(A, cfg, seed, n=300):
    """A seeded decide/observe/probe script over five request shapes, with
    epochs that advance at random; returns (tuner, decision records)."""
    t = A.AutoTuner(cfg)
    rng = np.random.default_rng(seed)
    keys = [A.workload_key(**K9),
            A.workload_key(target_recall=0.8, latency_budget_ms=2.0, k=3,
                           window=(0, 9), batch_rung=8),
            A.workload_key(target_recall=0.99, latency_budget_ms=0.01, k=5,
                           batch_rung=16),
            A.workload_key(k=5, batch_rung=8),
            A.workload_key(target_recall=1.0, k=5, window=(3, 40),
                           batch_rung=64)]
    epoch, records = 0, []
    for _ in range(n):
        epoch += int(rng.random() < 0.05)
        key = keys[int(rng.integers(len(keys)))]
        d = t.decide(key, epoch=epoch,
                     n_series=int(rng.integers(1 << 10, 1 << 22)))
        records.append(dataclasses.asdict(d))
        for kn, served in ((d.knobs, True), (d.shadow, False)):
            if kn is None:
                continue
            probed = t.should_probe(key, kn)
            lat = float(rng.gamma(2.0, 1.0 + kn.n_blocks))
            rec = float(rng.uniform(-0.1, 1.1)) if probed else None
            t.observe(key, kn, lat_ms=lat, epoch=epoch, recall=rec,
                      served=served)
    return t, records


@pytest.mark.parametrize("cfg,seed", [
    (dict(), 0), (dict(seed=7, epsilon=0.3), 1), (dict(seed=3, policy="ucb"), 2),
    (dict(seed=5, epsilon=1.0, forget=0.8, epoch_forget=0.3), 3),
    (dict(seed=9, max_trace=32, probe_frac=0.5, n_blocks_grid=(1, 4, 16)), 4),
    (dict(seed=11, forced=("approx", 2)), 5)])
def test_seeded_script_equals_the_reference(cfg, seed):
    def build(A):
        kw = dict(cfg)
        if "forced" in kw:
            kw["forced"] = A.Knobs(*kw["forced"])
        return A.AutoTunerConfig(**kw)

    pt, prec = _script(PA, build(PA), seed)
    rt, rrec = _script(RA, build(RA), seed)
    assert prec == rrec
    trace = pt.trace()
    assert trace == rt.trace()
    assert all(e["schema"] == DECISION_SCHEMA == RA.DECISION_SCHEMA == 1
               for e in trace)
    assert pt.snapshot() == rt.snapshot()
    assert pt.counters() == rt.counters()
    for lag, n in (({"lag_entries": 5000, "runs_pending_merge": 3}, 1 << 21),
                   ({"lag_entries": 0, "runs_pending_merge": 0}, 1000),
                   (None, 1 << 20), ({}, 0)):
        assert [dataclasses.asdict(e) for e in pt.advise_global(lag, n_series=n)] \
            == [dataclasses.asdict(e) for e in rt.advise_global(lag, n_series=n)]


def test_knob_grid_and_keys_equal_the_reference():
    assert [dataclasses.asdict(k) for k in PA.knob_grid()] == \
        [dataclasses.asdict(k) for k in RA.knob_grid()]
    for kw in (K9, dict(k=5, batch_rung=8, window=(0, 99)),
               dict(target_recall=0.12345, latency_budget_ms=0.123456, k=3,
                    window=(4, 4), batch_rung=64)):
        assert dataclasses.asdict(PA.workload_key(**kw)) == \
            dataclasses.asdict(RA.workload_key(**kw))


# ------------------------------------- the reference's checks, on the port
def test_knob_grid_shape():
    arms = knob_grid()
    assert arms[0] == Knobs("exact", 0)
    assert tuple(a.n_blocks for a in arms[1:]) == N_BLOCKS_GRID
    assert all(a.tier == "approx" for a in arms[1:])


def test_workload_key_buckets_windows_pow2():
    a = workload_key(target_recall=0.9, k=5, window=(0, 5), batch_rung=8)
    b = workload_key(target_recall=0.9, k=5, window=(2, 7), batch_rung=8)
    c = workload_key(target_recall=0.9, k=5, window=(0, 99), batch_rung=8)
    assert a == b and a != c
    assert workload_key(k=5, batch_rung=8).window_bucket == -1


def test_seeded_determinism():
    runs = []
    for _ in range(2):
        t = AutoTuner(AutoTunerConfig(seed=42))
        _drive(t, workload_key(**K9), n=120)
        runs.append(t.trace())
    assert runs[0] == runs[1]


def test_refit_converges_to_truly_best_arm():
    t = AutoTuner(AutoTunerConfig(seed=7, epsilon=0.3))
    _drive(t, workload_key(**K9), n=300)
    last = [e for e in t.trace() if e["kind"] == "decide"][-40:]
    picks = {(e["tier"], e["n_blocks"]) for e in last if not e["explore"]}
    assert picks == {("approx", 2)}, picks


def test_refit_estimates_near_ground_truth():
    t = AutoTuner(AutoTunerConfig(seed=1, epsilon=0.3))
    key = workload_key(**K9)
    _drive(t, key, n=300, jitter=0.1)
    for kn, arm in t._profiles[key].arms.items():
        lat, rec = _env(kn)
        if arm.lat_w < 6.0:  # unexplored arms keep their priors
            continue
        assert arm.lat_ms == pytest.approx(lat, rel=0.25)
        assert arm.recall == pytest.approx(rec, abs=0.05)


def test_profile_isolation():
    t = AutoTuner(AutoTunerConfig(seed=0))
    good = workload_key(**K9)
    bad = workload_key(target_recall=0.5, k=3, batch_rung=8)
    _drive(t, good, n=150)

    def fitted():
        return {kn: (a.lat_ms, a.recall, a.lat_w, a.recall_w)
                for kn, a in t._profiles[good].arms.items()}

    before = fitted()
    for _ in range(200):
        d = t.decide(bad, epoch=0, n_series=10**6)
        t.observe(bad, d.knobs, lat_ms=500.0, epoch=0, recall=0.01)
    assert fitted() == before


def test_strict_recall_is_always_exact():
    t = AutoTuner(AutoTunerConfig(seed=0, epsilon=1.0))
    key = workload_key(target_recall=1.0, k=5, batch_rung=16)
    for _ in range(50):
        d = t.decide(key, epoch=0, n_series=10**6)
        assert (d.knobs.tier, d.knobs.n_blocks, d.explore,
                d.shadow) == ("exact", 0, False, None)
    assert t.counters()["explores"] == 0


def test_untargeted_workload_is_exact():
    t = AutoTuner(AutoTunerConfig(seed=0, epsilon=1.0))
    d = t.decide(workload_key(k=5, batch_rung=8), epoch=0, n_series=10**6)
    assert d.knobs == Knobs("exact", 0)


def test_forced_arm_pins_every_decision():
    arm = Knobs("approx", 2)
    t = AutoTuner(AutoTunerConfig(seed=0, forced=arm))
    key = workload_key(**K9)
    for _ in range(30):
        d = t.decide(key, epoch=0, n_series=10**6)
        assert d.knobs == arm and not d.explore and d.shadow is None


def test_priors_match_static_tree_at_zero_observations():
    dec = serving_tier(Scenario(streaming=True, n_series=10**6, series_len=128,
                                uses_windows=True, target_recall=0.9,
                                query_batch=16))
    t = AutoTuner(AutoTunerConfig(seed=0, epsilon=0.0))
    d = t.decide(workload_key(**K9), epoch=0, n_series=10**6)
    assert (d.knobs.tier, d.knobs.n_blocks) == (dec.tier, dec.n_blocks)


def test_epoch_advance_decays_evidence():
    t = AutoTuner(AutoTunerConfig(seed=0, epoch_forget=0.5))
    key = workload_key(**K9)
    _drive(t, key, n=100, epoch=3)
    w_before = {kn: (a.lat_w, a.recall_w)
                for kn, a in t._profiles[key].arms.items()}
    t.decide(key, epoch=4, n_series=10**6)
    prof = t._profiles[key]
    assert t.counters()["epoch_refits"] == 1 and prof.last_epoch == 4
    for kn, (lw, rw) in w_before.items():
        assert prof.arms[kn].lat_w == pytest.approx(0.5 * lw)
        assert prof.arms[kn].recall_w == pytest.approx(0.5 * rw)
    t.decide(key, epoch=4, n_series=10**6)
    assert t.counters()["epoch_refits"] == 1


def test_exponential_forgetting_tracks_drift():
    t = AutoTuner(AutoTunerConfig(seed=0, forget=0.8))
    key = workload_key(**K9)
    arm = Knobs("approx", 2)
    for lat, rec in ((2.0, 0.95), (20.0, 0.6)):
        for _ in range(50):
            t.observe(key, arm, lat_ms=lat, epoch=0, recall=rec,
                      n_series=10**6)
    fitted = t._profiles[key].arms[arm]
    assert fitted.lat_ms == pytest.approx(20.0, rel=0.05)
    assert fitted.recall == pytest.approx(0.6, abs=0.02)


def test_conflict_when_nothing_feasible():
    t = AutoTuner(AutoTunerConfig(seed=0, epsilon=0.0))
    key = workload_key(target_recall=0.99, latency_budget_ms=0.01, k=5,
                       batch_rung=16)
    assert t.decide(key, epoch=0, n_series=10**6).conflict


def test_trace_schema():
    t = AutoTuner(AutoTunerConfig(seed=5))
    _drive(t, workload_key(**K9), n=80, epoch=2)
    trace = t.trace()
    assert trace
    legal_nb = {0} | set(N_BLOCKS_GRID)
    seqs = [e["seq"] for e in trace]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)
    epochs = [e["epoch"] for e in trace]
    assert epochs == sorted(epochs)
    for e in trace:
        assert e["schema"] == DECISION_SCHEMA
        assert e["kind"] in ("decide", "observe")
        assert e["tier"] in ("exact", "approx")
        assert e["n_blocks"] in legal_nb
        if e["tier"] == "exact":
            assert e["n_blocks"] == 0
        if e["kind"] == "observe":
            assert isinstance(e["served"], bool)
            if e["observed_recall"] is not None:
                assert 0.0 <= e["observed_recall"] <= 1.0
    assert any(e["kind"] == "observe" for e in trace)


def test_trace_is_bounded():
    t = AutoTuner(AutoTunerConfig(seed=0, max_trace=32))
    _drive(t, workload_key(**K9), n=100)
    assert len(t.trace()) == 32


def test_snapshot_is_jsonable():
    t = AutoTuner(AutoTunerConfig(seed=0))
    _drive(t, workload_key(**K9), n=40)
    json.dumps(t.snapshot())


def test_advise_global_flags_lagging_ingest():
    t = AutoTuner()
    lagging = {"lag_entries": 5000, "runs_pending_merge": 3}
    ids = [e.node_id for e in t.advise_global(lagging, n_series=1 << 21)]
    assert "advise/ingest-async" in ids and "advise/shard-mesh" in ids
    ids = [e.node_id for e in t.advise_global(
        {"lag_entries": 0, "runs_pending_merge": 0}, n_series=1000)]
    assert ids == ["advise/ingest-ok"]


# ---------------------------------------------------------------- gateway
@pytest.fixture(scope="module")
def small_index():
    from repro_torch.core import (StreamConfig, StreamingIndex,
                                  SummarizationConfig)

    scfg = SummarizationConfig(series_len=32, n_segments=8, card_bits=8)
    idx = StreamingIndex(StreamConfig(
        scheme="BTP", summarization=scfg, buffer_entries=256,
        growth_factor=4, block_size=64, device="cpu"))
    rng = np.random.default_rng(0)
    for b in range(3):
        x = np.cumsum(rng.normal(size=(200, 32)), axis=1,
                      dtype=np.float64).astype(np.float32)
        idx.ingest(x, np.full(200, b, np.int64))
    yield idx
    idx.close()


def _walks(n, seed):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(size=(n, 32)), axis=1,
                     dtype=np.float64).astype(np.float32)


def test_gateway_autotune_parity_and_feedback(small_index):
    """With the tuner routing, gateway answers equal the direct call at
    whatever tier was served, and every served batch feeds observations
    back into the tuner."""
    from repro_torch.core import Gateway, GatewayConfig

    gw = Gateway(small_index, GatewayConfig(
        deadline_ms=2.0, max_batch=8, k=3, autotune=True,
        autotune_cfg=AutoTunerConfig(seed=0)))
    try:
        Q = _walks(24, 9)
        resps = [gw.submit(Q[i], target_recall=0.9).result(timeout=60)
                 for i in range(Q.shape[0])]
        for i, r in enumerate(resps):
            if r.tier_served == "exact":
                vals, gids, _ = small_index.knn_batch(Q[i][None], k=3)
            else:
                vals, gids, _ = small_index.knn_approx_batch(
                    Q[i][None], k=3, n_blocks=max(r.n_blocks, 1))
            np.testing.assert_array_equal(r.ids, gids[0])
            np.testing.assert_array_equal(r.vals, vals[0])
        st = gw.snapshot()
        assert st.autotune
        assert st.tuner_decisions >= len(resps)
        assert st.tuner_observations >= len(resps)
        trace = gw.tuner.trace()
        assert any(e["kind"] == "observe" for e in trace)
        assert any(e["kind"] == "decide" for e in trace)
    finally:
        gw.close()


def test_gateway_strict_requests_stay_exact_under_autotune(small_index):
    from repro_torch.core import Gateway, GatewayConfig

    gw = Gateway(small_index, GatewayConfig(
        deadline_ms=2.0, max_batch=8, k=3, autotune=True,
        autotune_cfg=AutoTunerConfig(seed=0, epsilon=1.0)))
    try:
        Q = _walks(10, 2)
        for i in range(Q.shape[0]):
            r = gw.submit(Q[i], target_recall=1.0).result(timeout=60)
            assert r.tier_served == "exact" and not r.shed
    finally:
        gw.close()
