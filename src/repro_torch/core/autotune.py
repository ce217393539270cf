"""Online autotuning: the recommender's decision tree, closed-loop.

The static recommender (``core.recommender``) prices the serving tiers with
hard-coded cost constants and a calibrated recall curve. The serving stack
measures the real thing on every formed batch: per-sub-batch service
latency, recall@k vs the exact oracle (shadow probes), the registry epoch,
ingest lag. This module turns those observations into the decision:

* **Workload profiles** (:class:`WorkloadKey` -> per-arm fitted models) are
  keyed by request shape — tier targets, ``k``, the window-width bucket,
  the serving batch rung. A misbehaving tenant only ever updates its own
  profile, so one tenant's pathology cannot skew another's fitted model.
* **Online models with exponential forgetting**: each (profile, knob) arm
  holds an exponentially-forgotten latency estimate (mean + mean absolute
  deviation -> a p99 proxy) and a recall estimate. The static model's
  numbers enter as priors with ``prior_weight`` pseudo-observations;
  measurements wash them out at rate ``forget``.
* **A contextual bandit over the discrete knob grid** (epsilon-greedy by
  default, UCB optional): pick the feasible arm — fitted recall clears the
  target — with the lowest fitted p99 that fits the latency budget;
  explore with probability ``epsilon``. Decisions adapt **per registry
  epoch**: when the pinned epoch advances past a profile's last-seen
  epoch, that profile's evidence weights decay by ``epoch_forget`` (the
  data changed; old measurements say less).
* **Versioned decision records**: every decision and observation appends a
  frozen, schema-versioned record to a bounded trace — the BENCH
  adaptation artifacts and CI schema gates consume exactly this stream.

The gateway (``core.gateway``) is the production consumer: per-request
tier selection calls :meth:`AutoTuner.decide` instead of the frozen rule
node, and :meth:`AutoTuner.observe` feeds back after each formed batch.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from .recommender import (
    RationaleEntry, _approx_cost_ms, _approx_recall_model, _exact_cost_ms,
)

#: version of the decision/observation trace records; bump on field changes
DECISION_SCHEMA = 1

#: default discrete grid of the approximate tier's recall knob
N_BLOCKS_GRID = (1, 2, 4, 8, 16)


@dataclasses.dataclass(frozen=True)
class Knobs:
    """One point of the discrete knob grid the bandit navigates.

    ``tier``/``n_blocks`` are per-request knobs the gateway acts on;
    ``shard`` and ``ingest`` are deployment-scoped knobs carried for the
    global advice channel (:meth:`AutoTuner.advise_global`) — a gateway
    cannot flip them per request."""
    tier: str  # "exact" | "approx"
    n_blocks: int = 0  # approx tier recall knob (0 for exact)
    shard: Optional[str] = None  # None | "mesh"
    ingest: str = "sync"  # "sync" | "async"

    def label(self) -> str:
        return self.tier if self.tier == "exact" else f"approx{self.n_blocks}"


def knob_grid(n_blocks_grid: Tuple[int, ...] = N_BLOCKS_GRID,
              shard: Optional[str] = None,
              ingest: str = "sync") -> Tuple[Knobs, ...]:
    """The per-request arm set: exact plus one approx arm per grid point."""
    arms = [Knobs("exact", 0, shard, ingest)]
    arms += [Knobs("approx", nb, shard, ingest) for nb in n_blocks_grid]
    return tuple(arms)


@dataclasses.dataclass(frozen=True)
class WorkloadKey:
    """Request-shape profile key. Continuous inputs are bucketed so the
    profile table stays small and decisions stay stable."""
    target_recall: Optional[float]
    latency_budget_ms: Optional[float]
    k: int
    window_bucket: int  # -1 whole history, else pow2 bucket of window width
    batch_rung: int


def workload_key(*, target_recall: Optional[float] = None,
                 latency_budget_ms: Optional[float] = None, k: int,
                 window: Optional[tuple] = None,
                 batch_rung: int) -> WorkloadKey:
    wb = -1
    if window is not None:
        width = max(1, int(window[1]) - int(window[0]) + 1)
        wb = 1 << (width - 1).bit_length()
    tr = None if target_recall is None else round(float(target_recall), 3)
    lb = (None if latency_budget_ms is None
          else round(float(latency_budget_ms), 4))
    return WorkloadKey(tr, lb, int(k), wb, int(batch_rung))


@dataclasses.dataclass(frozen=True)
class DecisionRecord:
    """One frozen, versioned decision: what was chosen for which workload,
    under which epoch, and what the fitted models predicted at choice
    time. The gateway stamps responses from these; the trace stream is the
    BENCH adaptation artifact.

    ``shadow`` carries the bandit's exploration off the client path: the
    client is always served ``knobs`` (the greedy pick), and when
    ``shadow`` is set the gateway additionally measures that arm on the
    same sub-batch AFTER answers are resolved — exploration never inflates
    the explored request's (or its co-batched neighbors') latency."""
    schema: int
    seq: int
    epoch: int
    key: WorkloadKey
    knobs: Knobs
    explore: bool
    conflict: bool
    predicted_recall: float
    predicted_p99_ms: float
    shadow: Optional[Knobs] = None


class _Arm:
    """Mutable fitted state of one (profile, knob) arm. Exponential
    forgetting: value = (value*w*g + x) / (w*g + 1), w = w*g + 1 — the
    steady-state weight is 1/(1-g), so priors with weight ``prior_weight``
    wash out after a handful of measurements."""

    __slots__ = ("lat_ms", "lat_dev_ms", "recall", "lat_w", "recall_w")

    def __init__(self, lat_ms: float, recall: float, prior_weight: float):
        self.lat_ms = float(lat_ms)
        self.lat_dev_ms = 0.25 * float(lat_ms)  # wide prior tail
        self.recall = float(recall)
        self.lat_w = float(prior_weight)
        self.recall_w = float(prior_weight)

    @property
    def p99_ms(self) -> float:
        # mean + 3 deviations: a cheap, monotone tail proxy that only has
        # to RANK arms, not report calibrated percentiles
        return self.lat_ms + 3.0 * self.lat_dev_ms

    def observe_latency(self, x: float, g: float) -> None:
        w = self.lat_w * g
        self.lat_dev_ms = (self.lat_dev_ms * w + abs(x - self.lat_ms)) / (w + 1)
        self.lat_ms = (self.lat_ms * w + x) / (w + 1)
        self.lat_w = w + 1

    def observe_recall(self, x: float, g: float) -> None:
        w = self.recall_w * g
        self.recall = (self.recall * w + x) / (w + 1)
        self.recall_w = w + 1

    def decay(self, f: float) -> None:
        self.lat_w *= f
        self.recall_w *= f


class _Profile:
    """Per-workload fitted state: one ``_Arm`` per knob + bookkeeping."""

    __slots__ = ("arms", "last_epoch", "decisions")

    def __init__(self):
        self.arms: Dict[Knobs, _Arm] = {}
        self.last_epoch = -1
        self.decisions = 0


@dataclasses.dataclass(frozen=True)
class AutoTunerConfig:
    policy: str = "egreedy"  # "egreedy" | "ucb"
    epsilon: float = 0.05  # egreedy (shadow) exploration rate
    ucb_c: float = 1.0  # UCB optimism scale
    forget: float = 0.9  # per-observation exponential forgetting
    epoch_forget: float = 0.5  # evidence-weight decay when the epoch moves
    prior_weight: float = 2.0  # pseudo-observations behind the static priors
    recall_slack: float = 0.02  # fitted recall may undershoot target by this
    explore_bonus: float = 0.35  # optimism (/sqrt(evidence)) in the explore
    # guard: keeps arms whose fitted recall is still prior-dragged
    # explorable instead of freezing them out below target forever
    probe_frac: float = 0.25  # fraction of servings shadow-probed for recall
    probe_min_weight: float = 8.0  # always probe arms with less evidence
    seed: int = 0
    n_blocks_grid: Tuple[int, ...] = N_BLOCKS_GRID
    series_len: int = 128  # prior cost model input
    max_trace: int = 4096  # bounded decision/observation trace
    forced: Optional[Knobs] = None  # pin every decision (fixed-arm baselines)


class AutoTuner:
    """Measured-feedback knob controller over per-workload profiles.

    Thread-shared state (profiles, trace, RNG, counters) is guarded by
    ``self._lock``. The RNG is numpy's, seeded from ``AutoTunerConfig.seed``:
    it is host-side bandit state, and the same seed gives the JAX
    package's decisions.
    Strictly-exact workloads (no targets, or ``target_recall >= 1.0``) are
    contractually outside the bandit: they always get the exact tier."""

    def __init__(self, cfg: Optional[AutoTunerConfig] = None):
        self.cfg = cfg or AutoTunerConfig()
        self._lock = threading.Lock()
        self._rng = np.random.default_rng(self.cfg.seed)
        self._profiles: Dict[WorkloadKey, _Profile] = {}
        self._arms = knob_grid(self.cfg.n_blocks_grid)
        self._trace: deque = deque(maxlen=self.cfg.max_trace)
        self._seq = 0
        self.stats = {
            "decisions": 0,  # decide() calls (bandit + strict + forced)
            "explores": 0,  # decisions taken by the exploration branch
            "observations": 0,  # observe() calls folded into the models
            "probes": 0,  # should_probe() -> True (shadow recall measures)
            "epoch_refits": 0,  # profile evidence decays on epoch advance
        }

    # ----------------------------------------------------------- internals
    def _priors(self, key: WorkloadKey, n_series: int) -> Dict[Knobs, _Arm]:
        """Seed every arm from the static cost/recall model — the frozen
        rule tree's constants, demoted to priors."""
        n = max(1024, int(n_series))
        arms: Dict[Knobs, _Arm] = {}
        for kn in self._arms:
            if kn.tier == "exact":
                lat = _exact_cost_ms(n, key.batch_rung)
                rec = 1.0
            else:
                lat = _approx_cost_ms(kn.n_blocks, self.cfg.series_len)
                rec = _approx_recall_model(kn.n_blocks)
            arms[kn] = _Arm(lat, rec, self.cfg.prior_weight)
        return arms

    def _profile_locked(self, key: WorkloadKey, n_series: int) -> _Profile:
        prof = self._profiles.get(key)
        if prof is None:
            prof = _Profile()
            prof.arms = self._priors(key, n_series)
            self._profiles[key] = prof
        return prof

    def _refit_epoch_locked(self, prof: _Profile, epoch: int) -> None:
        """Epoch advanced -> the run set changed -> decay this profile's
        evidence weights so fresh measurements re-fit the models faster.
        The estimates themselves persist (the best guess until data says
        otherwise); only their certainty drops."""
        if prof.last_epoch >= 0 and epoch > prof.last_epoch:
            for arm in prof.arms.values():
                arm.decay(self.cfg.epoch_forget)
            self.stats["epoch_refits"] += 1
        prof.last_epoch = max(prof.last_epoch, epoch)

    @staticmethod
    def _is_strict(key: WorkloadKey) -> bool:
        if key.target_recall is None and key.latency_budget_ms is None:
            return True
        return key.target_recall is not None and key.target_recall >= 1.0

    def _pick_locked(self, prof: _Profile, key: WorkloadKey):
        """(knobs, shadow, explore, conflict) from the fitted models —
        ``knobs`` is always the greedy pick (the arm the client is
        served); ``shadow`` is the arm to measure off the client path when
        the exploration coin fires."""
        cfg = self.cfg
        arms = list(prof.arms.items())
        target = (key.target_recall if key.target_recall is not None else 0.9)
        budget = key.latency_budget_ms
        if cfg.policy == "ucb":
            # optimism in the face of uncertainty, both dimensions: recall
            # gets an upper bond, latency a lower one, scaled by evidence
            total = max(2.0, float(prof.decisions) + 1.0)

            def rec_hat(a: _Arm) -> float:
                return a.recall + cfg.ucb_c * math.sqrt(
                    math.log(total) / (a.recall_w + 1.0))

            def p99_hat(a: _Arm) -> float:
                bonus = cfg.ucb_c * a.lat_dev_ms * math.sqrt(
                    math.log(total) / (a.lat_w + 1.0))
                return max(0.0, a.p99_ms - bonus)
            explore = False
        else:
            def rec_hat(a: _Arm) -> float:
                return a.recall

            def p99_hat(a: _Arm) -> float:
                return a.p99_ms
            explore = bool(self._rng.random() < cfg.epsilon)
        feas = [(kn, a) for kn, a in arms
                if rec_hat(a) + cfg.recall_slack >= target]
        if not feas:
            # nothing clears the recall target: serve the best recall we
            # have and say so — the caller sheds/flags on conflict
            kn_g, _ = max(arms, key=lambda it: (rec_hat(it[1]),
                                                -p99_hat(it[1])))
            conflict = True
        elif budget is not None:
            in_budget = [(kn, a) for kn, a in feas if p99_hat(a) <= budget]
            if in_budget:
                kn_g, _ = min(in_budget, key=lambda it: p99_hat(it[1]))
                conflict = False
            else:
                # recall is reachable but not inside the budget: keep the
                # recall contract, flag the conflict (as the static tree)
                kn_g, _ = min(feas, key=lambda it: p99_hat(it[1]))
                conflict = True
        else:
            kn_g, _ = min(feas, key=lambda it: p99_hat(it[1]))
            conflict = False
        if explore:
            # GUARDED shadow exploration: the explored arm runs off the
            # client path, but it still occupies the dispatcher, so only
            # arms that could plausibly dethrone the greedy pick are worth
            # paying for — fitted p99 within 2x of it (or inside the
            # budget), and either already near the recall target or still
            # evidence-thin (epoch decay re-opens arms for re-exploration
            # after the data shifts)
            cap = 2.0 * p99_hat(prof.arms[kn_g])
            if budget is not None:
                cap = max(cap, budget)
            cands = [kn for kn, a in arms
                     if kn != kn_g and p99_hat(a) <= cap
                     and (rec_hat(a) + cfg.recall_slack
                          + cfg.explore_bonus
                          / math.sqrt(max(a.recall_w, 1.0)) >= target
                          or a.recall_w < cfg.probe_min_weight)]
            if cands:
                kn = cands[int(self._rng.integers(len(cands)))]
                return kn_g, kn, True, conflict
        return kn_g, None, False, conflict

    def _trace_locked(self, kind: str, epoch: int, key: WorkloadKey,
                      knobs: Knobs, **extra) -> int:
        seq = self._seq
        self._seq += 1
        entry = {
            "schema": DECISION_SCHEMA, "seq": seq, "kind": kind,
            "epoch": int(epoch), "tier": knobs.tier,
            "n_blocks": int(knobs.n_blocks),
            "key": {
                "target_recall": key.target_recall,
                "latency_budget_ms": key.latency_budget_ms,
                "k": key.k, "window_bucket": key.window_bucket,
                "batch_rung": key.batch_rung,
            },
        }
        entry.update(extra)
        self._trace.append(entry)
        return seq

    # ------------------------------------------------------------- deciding
    def decide(self, key: WorkloadKey, *, epoch: int,
               n_series: int) -> DecisionRecord:
        """Choose knobs for one request of shape ``key`` under registry
        ``epoch`` with ``n_series`` live entries (prior input only)."""
        with self._lock:
            prof = self._profile_locked(key, n_series)
            self._refit_epoch_locked(prof, epoch)
            prof.decisions += 1
            self.stats["decisions"] += 1
            if self.cfg.forced is not None:
                knobs, shadow, explore, conflict = (self.cfg.forced, None,
                                                    False, False)
                if knobs not in prof.arms:
                    prof.arms[knobs] = _Arm(1.0, 1.0 if knobs.tier == "exact"
                                            else _approx_recall_model(
                                                max(1, knobs.n_blocks)),
                                            self.cfg.prior_weight)
            elif self._is_strict(key):
                knobs, shadow, explore, conflict = (self._arms[0], None,
                                                    False, False)
            else:
                knobs, shadow, explore, conflict = self._pick_locked(prof,
                                                                     key)
            if explore:
                self.stats["explores"] += 1
            arm = prof.arms[knobs]
            extra = {}
            if shadow is not None:
                extra = {"shadow_tier": shadow.tier,
                         "shadow_n_blocks": shadow.n_blocks}
            seq = self._trace_locked(
                "decide", epoch, key, knobs, explore=explore,
                conflict=conflict,
                predicted_recall=round(arm.recall, 4),
                predicted_p99_ms=round(arm.p99_ms, 4), **extra)
            return DecisionRecord(
                DECISION_SCHEMA, seq, int(epoch), key, knobs, explore,
                conflict, arm.recall, arm.p99_ms, shadow)

    # ------------------------------------------------------------ observing
    def observe(self, key: WorkloadKey, knobs: Knobs, *, lat_ms: float,
                epoch: int, recall: Optional[float] = None,
                n_series: int = 0, served: bool = True) -> None:
        """Fold one measured outcome into ``key``'s model for ``knobs``.

        ``lat_ms`` is the sub-batch service latency; ``recall`` is the
        shadow-probed recall@k vs exact (None when unprobed — only the
        latency model updates). ``served=False`` marks shadow-exploration
        measurements of arms the client was *not* served — they train the
        model identically but are excluded when consumers score
        client-facing quality from the trace. Arms outside the configured
        grid (e.g. the gateway's SLO-shed override) are admitted lazily
        with priors."""
        with self._lock:
            prof = self._profile_locked(key, n_series)
            self._refit_epoch_locked(prof, epoch)
            arm = prof.arms.get(knobs)
            if arm is None:
                rec0 = (1.0 if knobs.tier == "exact"
                        else _approx_recall_model(max(1, knobs.n_blocks)))
                arm = prof.arms[knobs] = _Arm(max(lat_ms, 1e-3), rec0,
                                              self.cfg.prior_weight)
            arm.observe_latency(float(lat_ms), self.cfg.forget)
            if recall is not None:
                arm.observe_recall(float(np.clip(recall, 0.0, 1.0)),
                                   self.cfg.forget)
            self.stats["observations"] += 1
            self._trace_locked(
                "observe", epoch, key, knobs,
                observed_lat_ms=round(float(lat_ms), 4),
                observed_recall=(None if recall is None
                                 else round(float(np.clip(recall, 0.0, 1.0)),
                                            4)),
                served=bool(served))

    def should_probe(self, key: WorkloadKey, knobs: Knobs) -> bool:
        """Whether this serving should pay an exact shadow query to measure
        recall: always while the arm's recall evidence is thin, then a
        seeded ``probe_frac`` coin."""
        with self._lock:
            prof = self._profiles.get(key)
            arm = prof.arms.get(knobs) if prof is not None else None
            if arm is None or arm.recall_w < self.cfg.probe_min_weight:
                probe = True
            else:
                probe = bool(self._rng.random() < self.cfg.probe_frac)
            if probe:
                self.stats["probes"] += 1
            return probe

    # ------------------------------------------------------------ reporting
    def trace(self) -> List[dict]:
        """Copy of the bounded decision/observation trace (oldest first).
        Schema: see ``DECISION_SCHEMA`` and CONTRIBUTING 'Recommender &
        autotuning' — CI asserts monotone seq/epoch, legal knob values,
        observed recall in [0, 1]."""
        with self._lock:
            return [dict(e) for e in self._trace]

    def counters(self) -> dict:
        with self._lock:
            return dict(self.stats)

    def snapshot(self) -> dict:
        """Fitted-model snapshot: counters + per-profile per-arm estimates
        (JSON-able, for serve logs and BENCH artifacts)."""
        with self._lock:
            profiles = {}
            for key, prof in self._profiles.items():
                label = (f"tr={key.target_recall},lb={key.latency_budget_ms},"
                         f"k={key.k},w={key.window_bucket},b={key.batch_rung}")
                profiles[label] = {
                    kn.label(): {
                        "lat_ms": round(a.lat_ms, 4),
                        "p99_ms": round(a.p99_ms, 4),
                        "recall": round(a.recall, 4),
                        "lat_w": round(a.lat_w, 2),
                        "recall_w": round(a.recall_w, 2),
                    }
                    for kn, a in prof.arms.items()
                }
                profiles[label]["_decisions"] = prof.decisions
                profiles[label]["_last_epoch"] = prof.last_epoch
            return {**self.stats, "profiles": profiles}

    def advise_global(self, lag: Optional[dict] = None, *,
                      n_series: int = 0) -> Tuple[RationaleEntry, ...]:
        """Deployment-scoped knob advice (``ingest`` mode, ``shard``) from
        the live telemetry the per-request bandit cannot act on. Advisory
        only: these knobs need a restart/config change, so the tuner
        surfaces structured rationale instead of flipping them."""
        out: List[RationaleEntry] = []
        if lag:
            lagging = (lag.get("lag_entries", 0) > 0
                       and lag.get("runs_pending_merge", 0) > 0)
            if lagging:
                out.append(RationaleEntry(
                    "advise/ingest-async",
                    f"ingest lag {lag.get('lag_entries', 0)} entries with "
                    f"{lag.get('runs_pending_merge', 0)} runs pending merge "
                    "-> run ingest=async so compaction leaves the serving "
                    "thread"))
            else:
                out.append(RationaleEntry(
                    "advise/ingest-ok",
                    "ingest keeps up with the stream; sync ingest avoids "
                    "the background worker"))
        if n_series >= 1 << 20:
            out.append(RationaleEntry(
                "advise/shard-mesh",
                f"{n_series} live entries -> exact-tier scans benefit from "
                "shard='mesh' (queries x runs shard_map, answers bitwise "
                "equal)"))
        return tuple(out)
