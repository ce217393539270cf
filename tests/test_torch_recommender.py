"""The port's recommender against the reference's.

Every scenario of ``tests/test_recommender.py`` goes through both packages:
``recommend`` and ``serving_tier`` must agree field for field
(``dataclasses.asdict``), with the same ``describe()`` text and rationale
node ids. Then each of that file's checks runs on the port.
"""
import dataclasses

import pytest

pytest.importorskip("jax")

import repro.core.recommender as R  # noqa: E402
import repro_torch.core.recommender as P  # noqa: E402
from repro_torch.core import Scenario, recommend, serving_tier  # noqa: E402

# every Scenario the reference's recommender tests build
SCENARIOS = {
    "static-few-windows": dict(streaming=False, n_series=10**6,
                               expected_queries=5, uses_windows=True),
    "static-few": dict(streaming=False, n_series=10**6, expected_queries=5),
    "static-many": dict(streaming=False, n_series=10**6,
                        expected_queries=10**7),
    "stream-btp": dict(streaming=True, n_series=10**6, uses_windows=True,
                       ingest_rate=1e4),
    "stream-no-windows": dict(streaming=True, n_series=10**5,
                              uses_windows=False),
    "stream-write-heavy": dict(streaming=True, n_series=10**6,
                               uses_windows=True, ingest_rate=1e6,
                               expected_queries=10),
    "stream-read-heavy": dict(streaming=True, n_series=10**6,
                              uses_windows=True, ingest_rate=1.0,
                              expected_queries=10**5),
    "memory-budget": dict(streaming=False, n_series=10**7, series_len=256,
                          memory_budget_bytes=64 << 20),
    "stream-small": dict(streaming=True, n_series=1000, uses_windows=True),
    "no-targets": dict(streaming=False, n_series=10**6),
    "strict-recall": dict(streaming=False, n_series=10**6, target_recall=1.0),
    "relaxed-recall": dict(streaming=True, n_series=10**7, uses_windows=True,
                           target_recall=0.8),
    "recall-0.5": dict(streaming=False, n_series=10**6, target_recall=0.5),
    "recall-0.95": dict(streaming=False, n_series=10**6, target_recall=0.95),
    "tight-budget": dict(streaming=False, n_series=10**7,
                         latency_budget_ms=0.05),
    "loose-budget": dict(streaming=False, n_series=10**7, target_recall=0.95,
                         latency_budget_ms=100.0),
    "capped-budget": dict(streaming=False, n_series=10**7, target_recall=0.95,
                          latency_budget_ms=0.3),
    "generous-budget": dict(streaming=False, n_series=10**4,
                            latency_budget_ms=100.0),
    "batch-64": dict(streaming=True, n_series=10**6, uses_windows=True,
                     target_recall=0.7, query_batch=64),
    "stream-recall-0.8": dict(streaming=True, n_series=10**6,
                              uses_windows=True, target_recall=0.8),
    "static-recall-0.9": dict(streaming=False, n_series=10**7,
                              target_recall=0.9),
    "stream-conflict": dict(streaming=True, n_series=10**6, uses_windows=True,
                            target_recall=0.95, latency_budget_ms=0.3),
    "profile-strict": dict(streaming=True, n_series=10**6, target_recall=1.0),
    "profile-tight": dict(streaming=True, n_series=10**6, target_recall=0.9,
                          latency_budget_ms=0.05),
    "profile-recall-0.8": dict(streaming=True, n_series=10**6,
                               target_recall=0.8),
    "profile-plain": dict(streaming=True, n_series=10**6),
    "node-ids": dict(streaming=True, n_series=10**6, uses_windows=True,
                     target_recall=0.9, latency_budget_ms=0.3),
    "static-recall-0.8": dict(streaming=False, n_series=10**6,
                              target_recall=0.8),
    "embedded": dict(streaming=True, n_series=10**7, uses_windows=True,
                     target_recall=0.85, query_batch=16),
    "exact-fits-budget": dict(streaming=False, n_series=10**4,
                              target_recall=0.9, latency_budget_ms=100.0),
}


def _rec(name):
    return recommend(Scenario(**SCENARIOS[name]))


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_recommendation_equals_the_reference(name):
    kw = SCENARIOS[name]
    got, want = P.recommend(P.Scenario(**kw)), R.recommend(R.Scenario(**kw))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.describe() == want.describe()
    assert [e.node_id for e in got.rationale] == \
        [e.node_id for e in want.rationale]
    assert (got.tier, got.n_blocks, got.conflict) == \
        (want.tier, want.n_blocks, want.conflict)
    dec, ref = P.serving_tier(P.Scenario(**kw)), R.serving_tier(R.Scenario(**kw))
    assert dataclasses.asdict(dec) == dataclasses.asdict(ref)
    assert [e.node_id for e in dec.rationale] == \
        [e.node_id for e in ref.rationale]


def test_priors_equal_the_reference():
    for nb in (1, 2, 4, 8, 16, 64):
        assert P._approx_recall_model(nb) == R._approx_recall_model(nb)
        assert P._approx_cost_ms(nb, 256) == R._approx_cost_ms(nb, 256)
    for n, qb in ((10**4, 1), (10**6, 16), (10**7, 64)):
        assert P._exact_cost_ms(n, qb) == R._exact_cost_ms(n, qb)


# ------------------------------------- the reference's checks, on the port
def test_scenario1_static_few_queries_nonmat_ctree_pp():
    rec = _rec("static-few-windows")
    assert rec.index == "ctree" and not rec.materialized and rec.scheme == "PP"
    assert rec.rationale


def test_scenario1_many_queries_flips_to_materialized():
    assert not _rec("static-few").materialized
    assert _rec("static-many").materialized


def test_scenario2_streaming_clsm_btp():
    rec = _rec("stream-btp")
    assert rec.index == "clsm" and rec.scheme == "BTP" and not rec.materialized


def test_streaming_without_windows_uses_pp():
    assert _rec("stream-no-windows").scheme == "PP"


def test_write_heavy_stream_gets_larger_growth_factor():
    assert _rec("stream-write-heavy").growth_factor > \
        _rec("stream-read-heavy").growth_factor


def test_memory_budget_reflected_in_rationale():
    rec = _rec("memory-budget")
    assert any("two-pass" in r for r in rec.rationale)
    assert rec.mem_budget_entries * 256 * 4 <= (64 << 20) + 2**20


def test_describe_renders():
    text = _rec("stream-small").describe()
    assert "CLSM" in text and "because" in text


def test_no_targets_keeps_exact_tier():
    rec = _rec("no-targets")
    assert rec.tier == "exact" and rec.n_blocks == 0


def test_target_recall_one_requires_exact_tier():
    rec = _rec("strict-recall")
    assert rec.tier == "exact"
    assert any("exact tier" in r for r in rec.rationale)


def test_relaxed_recall_picks_approx_tier():
    rec = _rec("relaxed-recall")
    assert rec.tier == "approx" and rec.n_blocks >= 1


def test_higher_target_recall_needs_more_blocks():
    lo, hi = _rec("recall-0.5"), _rec("recall-0.95")
    assert lo.tier == hi.tier == "approx"
    assert hi.n_blocks > lo.n_blocks


def test_tight_latency_budget_flips_to_approx_and_caps_blocks():
    assert _rec("tight-budget").tier == "approx"
    assert _rec("capped-budget").n_blocks <= _rec("loose-budget").n_blocks


def test_conflicting_recall_and_latency_targets_warn():
    rec = _rec("capped-budget")
    if P._approx_recall_model(rec.n_blocks) < 0.95:
        assert any("WARNING" in r for r in rec.rationale)


def test_generous_latency_budget_keeps_exact():
    assert _rec("generous-budget").tier == "exact"


def test_query_batch_amortization_in_rationale():
    rec = _rec("batch-64")
    assert rec.tier == "approx"
    assert any("coalesced" in r or "amortiz" in r for r in rec.rationale)


def test_approx_tier_renders_in_describe():
    assert "approx tier" in _rec("stream-recall-0.8").describe()


def test_conflict_is_a_structured_flag_not_just_a_string():
    rec = _rec("capped-budget")
    assert rec.conflict == any("WARNING" in r for r in rec.rationale)
    clean = _rec("static-recall-0.9")
    assert not clean.conflict
    assert not any("WARNING" in r for r in clean.rationale)


def test_serving_tier_standalone_matches_recommend():
    s = Scenario(**SCENARIOS["stream-conflict"])
    dec, rec = serving_tier(s), recommend(s)
    assert (dec.tier, dec.n_blocks, dec.conflict) == \
        (rec.tier, rec.n_blocks, rec.conflict)
    assert dec.conflict == any("WARNING" in r for r in dec.rationale)


def test_serving_tier_is_deterministic_per_profile():
    profiles = [Scenario(**SCENARIOS[n]) for n in (
        "profile-strict", "profile-tight", "profile-recall-0.8",
        "profile-plain")]
    first = [serving_tier(p) for p in profiles]
    for _ in range(3):
        assert [serving_tier(p) for p in profiles] == first
    assert first[0].tier == "exact" and not first[0].conflict
    assert first[1].tier == "approx" and first[1].conflict
    assert first[3] == serving_tier(profiles[3])


def test_rationale_entries_carry_stable_node_ids():
    rec = _rec("node-ids")
    ids = [e.node_id for e in rec.rationale]
    assert all("/" in i for i in ids), ids
    assert "ingest/streaming" in ids
    assert any(i.startswith("serve/") for i in ids)
    assert f"[{ids[0]}]" in rec.describe()


def test_decision_objects_are_frozen():
    rec = _rec("static-recall-0.8")
    with pytest.raises(dataclasses.FrozenInstanceError):
        rec.index = "clsm"
    with pytest.raises(dataclasses.FrozenInstanceError):
        rec.decision.tier = "exact"
    with pytest.raises(dataclasses.FrozenInstanceError):
        rec.rationale[0].text = "x"


def test_embedded_decision_matches_standalone_serving_tier():
    s = Scenario(**SCENARIOS["embedded"])
    assert recommend(s).decision == serving_tier(s)


def test_embedded_decision_rationale_is_the_serving_slice():
    rec = _rec("stream-recall-0.8")
    assert rec.decision.rationale
    assert all(e.node_id.startswith("serve/") for e in rec.decision.rationale)
    assert len(rec.decision.rationale) < len(rec.rationale)


def test_rationale_entry_back_compat_reads_as_string():
    e = _rec("no-targets").rationale[0]
    assert str(e) == e.text
    assert e.text[:4] in e


def test_exact_fits_budget_beats_approx_regression():
    dec = serving_tier(Scenario(**SCENARIOS["exact-fits-budget"]))
    assert dec.tier == "exact" and dec.n_blocks == 0
    assert not dec.conflict
    assert "serve/exact-fits-budget" in [e.node_id for e in dec.rationale]
