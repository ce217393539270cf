"""The Coconut Palm recommender — a decision tree over application scenarios.

Mirrors the demo's tool: given a scenario description (static vs streaming,
data volume, expected query count, memory budget, window sizes) it picks an
index structure + materialization + temporal scheme and, because it is a
decision tree, returns the *rationale chain* of every decision it took
(paper §4: "designed as a decision tree to be able to provide users with the
rationale for its advice").

The thresholds encode the paper's demo narratives:
  * Scenario 1 (static, few queries)  -> non-materialized CTree + PP
  * Scenario 1 (static, many queries) -> materialized CTree
  * Scenario 2 (streaming)            -> non-materialized CLSM + BTP

Decision surface (one frozen record family — the autotuner's feedback loop
consumes these, so they are structured and immutable, not free-form):

* :class:`RationaleEntry` — one ``(node_id, text)`` step of the decision
  tree. ``node_id`` is the stable machine key ("serve/latency-cap"); the
  text is the human narrative. ``in`` / ``str()`` keep the old bare-string
  reading working for one release.
* :class:`TierDecision` — the serving-tier verdict (tier, n_blocks,
  conflict) with its rationale chain.
* :class:`Recommendation` — the full-tree verdict; it *embeds* its
  ``TierDecision`` (``rec.decision``) and keeps ``tier`` / ``n_blocks`` /
  ``conflict`` as thin back-compat read-only properties for one release.

The cost-model constants below are the *priors* of the online autotuner
(``core.autotune``): a live serving stack re-fits the latency and recall
models from measured batches and only falls back to these numbers before
any observations exist.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Scenario:
    streaming: bool
    n_series: int
    series_len: int = 256
    expected_queries: int = 100
    memory_budget_bytes: int = 1 << 30
    uses_windows: bool = False
    ingest_rate: float = 0.0  # series/sec arriving (streaming)
    read_heavy: Optional[bool] = None  # override read/write balance
    # serving-tier inputs (None = exact answers required)
    target_recall: Optional[float] = None  # acceptable recall@k vs exact
    latency_budget_ms: Optional[float] = None  # per-query modeled I/O budget
    query_batch: int = 1  # concurrent queries per serving batch


@dataclasses.dataclass(frozen=True)
class RationaleEntry:
    """One decision-tree step: a stable node id + the human narrative.

    Back-compat (one release): the old surface was a bare string, so
    ``"WARNING" in entry`` and ``str(entry)`` keep reading the text."""
    node_id: str
    text: str

    def __contains__(self, item: str) -> bool:
        return item in self.text

    def __str__(self) -> str:
        return self.text


@dataclasses.dataclass(frozen=True)
class TierDecision:
    """Structured serving-tier verdict for one request profile.

    ``conflict`` is the machine-readable form of the "latency cap makes the
    recall target unreachable" warning: admission layers (the serving
    gateway) must treat it as a shed signal instead of relying on a string
    buried in the rationale chain."""
    tier: str  # "exact" | "approx"
    n_blocks: int  # approx tier: adjacent blocks per (query, run)
    conflict: bool
    rationale: Tuple[RationaleEntry, ...]


@dataclasses.dataclass(frozen=True)
class Recommendation:
    """Full decision-tree verdict: index layout + the embedded serving-tier
    decision. Frozen — downstream layers (gateway routing, the autotuner's
    decision records, BENCH emitters) hold references to these; a published
    recommendation must never mutate under them."""
    index: str  # "ctree" | "clsm"
    materialized: bool
    scheme: str  # "PP" | "TP" | "BTP" | "-"
    growth_factor: int
    fill_factor: float
    mem_budget_entries: int
    decision: TierDecision
    rationale: Tuple[RationaleEntry, ...] = ()

    # -- thin back-compat properties (one release): old callers read the
    # serving-tier fields directly off the recommendation
    @property
    def tier(self) -> str:
        return self.decision.tier

    @property
    def n_blocks(self) -> int:
        return self.decision.n_blocks

    @property
    def conflict(self) -> bool:
        return self.decision.conflict

    def describe(self) -> str:
        mat = "materialized" if self.materialized else "non-materialized"
        head = f"{mat} {self.index.upper()}" + (f" with {self.scheme}" if self.scheme != "-" else "")
        if self.tier == "approx":
            head += f", approx tier (n_blocks={self.n_blocks})"
        return head + "\n  because:\n" + "\n".join(
            f"  - [{e.node_id}] {e.text}" for e in self.rationale)


# cost-model constants used by the break-even analysis (bytes). These are
# the PRIORS of core.autotune's online models — live serving re-fits them.
_RAW_BYTES = 4
_BLOCK_ENTRIES = 1024  # nominal entries per sequential block read
_SEQ_MBPS = 500.0  # modeled disk (io_model.DiskModel defaults)
_RAND_IOPS = 10_000.0
_EXACT_VERIFIED_FRAC = 0.002  # fraction of N verified per exact query


def _approx_recall_model(n_blocks: int) -> float:
    """Modeled recall@k of the approximate tier at ``n_blocks`` adjacent
    blocks per (query, run). Sortable keys keep a query's true neighbors
    clustered around its seek position, with coverage saturating roughly
    geometrically as the window widens — calibrated against the repo's
    recall-validation harness on the random-walk datasets (n_blocks=1 ~0.5,
    2 ~0.7, 8 ~0.95)."""
    return 1.0 - 0.55 * (0.72 ** (n_blocks - 1))


def _exact_cost_ms(n_series: int, query_batch: int) -> float:
    """Modeled per-query exact cost: LB-surviving random fetches (amortized
    ~linearly by batching, which shares verification passes)."""
    batch_amort = max(1.0, min(float(query_batch), 8.0))
    return n_series * _EXACT_VERIFIED_FRAC / batch_amort / _RAND_IOPS * 1e3


def _approx_cost_ms(n_blocks: int, series_len: int) -> float:
    """Modeled per-query approximate cost: ``n_blocks`` sequential block
    reads per (query, run)."""
    entry_bytes = series_len * _RAW_BYTES
    return n_blocks * _BLOCK_ENTRIES * entry_bytes / (_SEQ_MBPS * 1e6) * 1e3


def serving_tier(s: Scenario) -> TierDecision:
    """Per-request tier selection: the serving-tier node of the decision
    tree, standalone, with the recall/latency conflict surfaced as a flag.
    Deterministic in ``s`` (``Scenario`` is frozen), so callers may cache
    decisions per request profile."""
    r: List[RationaleEntry] = []
    tier, n_blocks, conflict = _serving_tier(s, r)
    return TierDecision(tier, n_blocks, conflict, tuple(r))


def _say(r: List[RationaleEntry], node_id: str, text: str) -> None:
    r.append(RationaleEntry(node_id, text))


def _serving_tier(s: Scenario, r: List[RationaleEntry]) -> tuple:
    """Decision-tree node: pick the serving tier + its recall knob from the
    target recall and per-query latency budget. Returns (tier, n_blocks,
    conflict) where ``conflict`` is True when the latency cap forced
    n_blocks below what the recall target needs."""
    exact_ms = _exact_cost_ms(s.n_series, s.query_batch)
    if s.target_recall is None and s.latency_budget_ms is None:
        return "exact", 0, False
    if s.target_recall is not None and s.target_recall >= 1.0:
        _say(r, "serve/strict-recall",
             "target recall 1.0 -> only the exact tier guarantees it; "
             "the approximate tier is a strict subset of the exact answer")
        return "exact", 0, False
    if s.latency_budget_ms is not None and exact_ms <= s.latency_budget_ms:
        # exact satisfies BOTH constraints: recall 1.0 clears any target and
        # the modeled cost fits the budget — a relaxed recall target is a
        # floor, not a request for weaker answers
        _say(r, "serve/exact-fits-budget",
             f"modeled exact query I/O ~{exact_ms:.2f} ms fits the "
             f"{s.latency_budget_ms:.2f} ms budget at batch {s.query_batch}"
             + (" and recall 1.0 clears the "
                f"{s.target_recall:.2f} target" if s.target_recall is not None
                else "") + " -> keep exact answers")
        return "exact", 0, False
    # approximate tier: choose the smallest n_blocks whose modeled recall
    # clears the target and whose sequential bytes fit the budget
    target = s.target_recall if s.target_recall is not None else 0.9
    nb = 1
    while nb < 64 and _approx_recall_model(nb) < target:
        nb *= 2
    seq_ms = _approx_cost_ms(nb, s.series_len)
    _say(r, "serve/approx-depth",
         f"target recall@k {target:.2f} < 1 -> approximate tier: one key "
         f"seek + {nb} adjacent block(s) read sequentially per (query, run) "
         f"(modeled recall ~{_approx_recall_model(nb):.2f})")
    conflict = False
    if s.latency_budget_ms is not None:
        uncapped = nb
        while nb > 1 and seq_ms > s.latency_budget_ms:
            nb //= 2
            seq_ms = _approx_cost_ms(nb, s.series_len)
        _say(r, "serve/latency-cap",
             f"latency budget {s.latency_budget_ms:.2f} ms/query caps the "
             f"sequential read at n_blocks={nb} (~{seq_ms:.2f} ms modeled); "
             f"exact would cost ~{exact_ms:.2f} ms")
        if nb < uncapped and _approx_recall_model(nb) < target:
            conflict = True
            _say(r, "serve/conflict",
                 f"WARNING: at the capped n_blocks={nb} the modeled recall "
                 f"drops to ~{_approx_recall_model(nb):.2f}, below the "
                 f"{target:.2f} target — the recall and latency goals "
                 "conflict; relax one of them")
    if s.query_batch > 1:
        _say(r, "serve/batch-amortization",
             f"batch of {s.query_batch} concurrent queries shares one "
             "vectorized key seek and coalesced sequential reads per run, so "
             "the per-query seek cost amortizes toward zero")
    return "approx", nb, conflict


def recommend(s: Scenario) -> Recommendation:
    r: List[RationaleEntry] = []
    entry_bytes = s.series_len * _RAW_BYTES
    data_bytes = s.n_series * entry_bytes
    mem_entries = max(1024, s.memory_budget_bytes // max(1, entry_bytes))

    # --- node 1: ingestion pattern ------------------------------------------
    if s.streaming:
        index = "clsm"
        _say(r, "ingest/streaming",
             "data arrives continuously -> log-structured merges ingest with "
             "sequential writes only (CLSM); a CTree would need top-down "
             "updates or full rebuilds")
        # node 1a: temporal scheme
        if s.uses_windows:
            scheme = "BTP"
            _say(r, "temporal/btp",
                 "window queries benefit from temporal partitions; bounded "
                 "merging (BTP) keeps recent data in small skippable runs while "
                 "large merged runs keep strong spatial pruning for wide windows")
        else:
            scheme = "PP"
            _say(r, "temporal/pp",
                 "no window constraints -> pure post-filtering (PP) on the "
                 "fully merged structure; temporal partitions would add probes "
                 "without enabling skips")
        # node 1b: read/write balance -> growth factor
        qps = s.expected_queries
        write_heavy = s.read_heavy is False or (
            s.read_heavy is None and s.ingest_rate > max(1.0, qps)
        )
        growth = 8 if write_heavy else 3
        _say(r, "merge/growth-factor",
             ("ingest rate dominates queries -> large growth factor (%d) defers merge work"
              if write_heavy
              else "queries dominate ingest -> small growth factor (%d) keeps few runs per probe")
             % growth)
        # node 1c: materialization under ingest pressure
        materialized = False
        _say(r, "materialize/streaming",
             "streaming ingest + merges rewrite data repeatedly -> keep runs "
             "non-materialized; verification reads fetch from the raw log")
        # node 1d: serving tier from the recall/latency targets
        n0 = len(r)
        tier, n_blocks, conflict = _serving_tier(s, r)
        decision = TierDecision(tier, n_blocks, conflict, tuple(r[n0:]))
        return Recommendation(index, materialized, scheme, growth, 1.0,
                              mem_entries, decision, tuple(r))

    # --- static data ----------------------------------------------------------
    index = "ctree"
    _say(r, "ingest/static",
         "static collection -> bulk-build once with a two-pass external sort; "
         "the read-optimized contiguous CTree gives the fastest scans")
    scheme = "PP" if s.uses_windows else "-"
    if s.uses_windows:
        _say(r, "temporal/static-pp",
             "static data has no flush-time partitions; window constraints are "
             "post-filtered on timestamps (PP)")

    # node 2: materialization break-even.
    # Non-materialized build writes only summaries (~w+key bytes/entry);
    # materialized also rewrites the raw data (entry_bytes). Each exact query
    # on a non-materialized index pays ~verified_frac random fetches.
    verified_frac = 0.002  # fraction of N fetched per exact query (post-LB)
    extra_build = s.n_series * entry_bytes  # extra sequential bytes if materialized
    per_query_penalty = s.n_series * verified_frac * entry_bytes  # random bytes
    # random I/O ~20x more expensive per byte than sequential on the modeled disk
    break_even_queries = max(1, int(extra_build / (20.0 * max(per_query_penalty, 1))))
    if s.expected_queries > break_even_queries:
        materialized = True
        _say(r, "materialize/break-even",
             f"expected {s.expected_queries} queries > break-even {break_even_queries}: "
             "the one-off cost of materializing raw series in sorted order is "
             "amortized by removing random fetches from every query")
    else:
        materialized = False
        _say(r, "materialize/break-even",
             f"expected {s.expected_queries} queries <= break-even {break_even_queries}: "
             "build the skeletal (summaries-only) index — faster to build, "
             "smaller on storage; queries fetch raw series on demand")

    # node 3: memory budget -> external-sort passes
    if s.memory_budget_bytes < data_bytes:
        _say(r, "build/external-sort",
             f"memory budget {s.memory_budget_bytes >> 20} MiB < data "
             f"{data_bytes >> 20} MiB -> two-pass external sort with "
             f"{mem_entries} entry chunks (still sequential I/O only)")
    else:
        _say(r, "build/in-memory",
             "data fits in memory -> single in-memory sort pass")

    # node 4: update tolerance -> fill factor
    fill = 1.0 if s.ingest_rate == 0 else 0.8
    if fill < 1.0:
        _say(r, "build/fill-factor",
             "occasional updates expected -> leaf fill factor 0.8 leaves gaps")

    # node 5: serving tier from the recall/latency targets
    n0 = len(r)
    tier, n_blocks, conflict = _serving_tier(s, r)
    decision = TierDecision(tier, n_blocks, conflict, tuple(r[n0:]))
    return Recommendation(index, materialized, scheme, 3, fill, mem_entries,
                          decision, tuple(r))
