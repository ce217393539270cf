"""SLO-aware dynamic-batching serving gateway.

The engine serves *batches*; interactive traffic arrives as independent
single queries. This module is the admission-control layer between them
(the shape production inference stacks call continuous batching):

* an admission queue coalesces arriving queries into the largest batch
  rung available — the rungs are exactly the verify engine's query-batch
  buckets (``_bucket_batch``: powers of two, min 8), so a prewarmed
  gateway meets no new pass signature at serve time;
* a **deadline flush** guarantees no query waits more than
  ``deadline_ms`` in queue: when the oldest request's deadline expires the
  batch is flushed as-is and padded up to the rung floor with copies of
  real queries (padding rows are sliced off before results are returned —
  per-query answers are independent of batch composition, so padding
  never changes them);
* **per-request tier selection** routes each request through the
  recommender's serving-tier node (``target_recall`` /
  ``latency_budget_ms`` per request): one formed batch fans out into
  per-(tier, n_blocks, k, window) sub-batches, all answered against ONE
  pinned epoch snapshot;
* with ``GatewayConfig(autotune=True)`` tier selection consults the
  online :class:`~repro_torch.core.autotune.AutoTuner` instead of the frozen
  rule node: each sub-batch's measured service latency (and, on probed
  servings, shadow-measured recall@k vs exact) feeds the per-workload
  fitted models back after every formed batch;
* **backpressure sheds to the approximate tier** — not into an unbounded
  queue: the admission queue is bounded (``max_queue``; ``submit``
  blocks), and when the measured rolling p99 drifts past ``slo_p99_ms``
  the gateway starts answering sheddable exact-tier requests on the
  approximate tier instead, with hysteresis (``shed_exit_frac``) so it
  recovers. Requests with ``target_recall >= 1.0`` are contractually
  exact and are never shed; a recommender ``conflict`` (the latency cap
  makes the recall target unreachable) is itself a shed signal.

Every response carries provenance: ``tier_served``, ``shed``,
``conflict``, ``queue_wait_ms``, the formed/padded batch shape, and the
epoch the answer was pinned to.

The engine passes run on the index's device (``StreamConfig.device``):
on the dispatcher thread, so a CUDA index screens off the clients'
threads, and an error there reaches every ticket of its batch.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Optional

import numpy as np

from .autotune import AutoTuner, AutoTunerConfig, Knobs, workload_key
from .execute import recall_at_k
from .recommender import Scenario, TierDecision, serving_tier
from .verify_engine import _CHUNK_M, _bucket_batch, get_engine


@dataclasses.dataclass(frozen=True)
class GatewayConfig:
    deadline_ms: float = 5.0  # max in-queue wait before a flush
    slo_p99_ms: float = 50.0  # rolling-p99 target that triggers shedding
    max_batch: int = 64  # largest formed batch (top ladder rung)
    k: int = 5  # default neighbors per query
    max_queue: int = 4096  # admission bound; submit() blocks beyond it
    lat_window: int = 256  # completions in the rolling percentile window
    min_shed_samples: int = 32  # completions before shedding may engage
    shed_exit_frac: float = 0.7  # recover when p99 < frac * slo (hysteresis)
    shed_n_blocks: int = 2  # approx recall knob for shed serves
    autotune: bool = False  # tier selection via the online AutoTuner
    autotune_cfg: Optional[AutoTunerConfig] = None  # tuner knobs


@dataclasses.dataclass(frozen=True)
class GatewayStats:
    """Typed point-in-time gateway snapshot.

    The counter vocabulary lines up with ``VerifyEngine.stats`` where the
    concepts overlap (histograms as value->count dicts, byte/event
    counters as plain ints) so BENCH emitters and the autotuner consume
    one documented schema; ``snapshot_stats()`` keeps returning the same
    keys as a dict view for existing callers."""
    submitted: int  # submit() admissions
    served: int  # resolved responses
    shed_served: int  # answers downgraded to approx (or conflicted)
    conflicts: int  # recommender recall/latency conflicts seen
    batches: int  # formed batches dispatched
    deadline_flushes: int  # batches flushed below the top rung
    full_flushes: int  # batches formed at the top rung
    shed_transitions: int  # enter/exit events of the shed state
    batch_hist: dict  # formed (real) batch size -> count
    queue_depth: int  # requests waiting at snapshot time
    shedding: bool  # shed state at snapshot time
    p50_ms: float  # rolling window median latency
    p99_ms: float  # rolling window tail latency (the SLO gate input)
    autotune: bool  # online tuner active
    tuner_decisions: int  # AutoTuner.decide() calls
    tuner_explores: int  # decisions taken by the exploration branch
    tuner_observations: int  # measured outcomes folded into the models
    tuner_probes: int  # shadow exact recall measurements paid


@dataclasses.dataclass
class Response:
    """One client answer + its serving provenance."""
    vals: np.ndarray  # (k,) f64 squared distances, ascending
    ids: np.ndarray  # (k,) int64 global ids (-1 padded)
    tier_served: str  # "exact" | "approx"
    n_blocks: int  # approx tier recall knob used (0 for exact)
    shed: bool  # True when SLO pressure / a conflict downgraded the tier
    conflict: bool  # recommender: latency cap made recall unreachable
    queue_wait_ms: float  # admission -> batch dispatch
    latency_ms: float  # admission -> answer
    batch_size: int  # real queries in the formed batch
    padded_to: int  # ladder rung the sub-batch was padded to
    epoch: int  # pinned snapshot the whole formed batch answered against


@dataclasses.dataclass
class _Request:
    q: np.ndarray
    k: int
    window: Optional[tuple]
    target_recall: Optional[float]
    latency_budget_ms: Optional[float]
    t_arrive: float
    ticket: "Ticket"


class Ticket:
    """Handle returned by ``Gateway.submit``; ``result()`` blocks until the
    dispatcher resolves it."""

    __slots__ = ("_ev", "_resp", "_err")

    def __init__(self):
        self._ev = threading.Event()
        self._resp: Optional[Response] = None
        self._err: Optional[BaseException] = None

    def _resolve(self, resp: Optional[Response] = None,
                 err: Optional[BaseException] = None) -> None:
        self._resp, self._err = resp, err
        self._ev.set()

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None) -> Response:
        if not self._ev.wait(timeout):
            raise TimeoutError("gateway response pending")
        if self._err is not None:
            raise self._err
        return self._resp


def ladder(max_batch: int) -> tuple:
    """The gateway's batch rungs: the engine's query-batch buckets (pow2,
    min 8) up to ``max_batch`` — shared so prewarm covers exactly the
    shapes the dispatcher can form."""
    rungs, m = [], 8
    while m < max_batch:
        rungs.append(m)
        m *= 2
    rungs.append(max_batch)
    return tuple(rungs)


class Gateway:
    """Admission queue + dispatcher thread over a ``StreamingIndex``.

    Thread-shared state (queue, rolling latencies, shed flag, stats,
    tier-decision cache) is guarded by ``self._cond``. Device work (the
    engine passes) runs OUTSIDE the lock so clients keep submitting while
    a batch serves."""

    def __init__(self, index, cfg: Optional[GatewayConfig] = None):
        self._idx = index
        self.cfg = cfg or GatewayConfig()
        if self.cfg.max_batch > _CHUNK_M:
            raise ValueError(
                f"max_batch {self.cfg.max_batch} exceeds the engine's query "
                f"chunk {_CHUNK_M}; larger formed batches would split into "
                "multiple passes and defeat the ladder accounting")
        self._cond = threading.Condition()
        self._queue: deque = deque()
        self._lat_ms: deque = deque(maxlen=self.cfg.lat_window)
        self._shedding = False
        self._closed = False
        self._settled = 0  # admitted requests accounted (or failed)
        self._tier_cache: dict = {}
        self.tuner: Optional[AutoTuner] = None
        if self.cfg.autotune:
            self.tuner = AutoTuner(self.cfg.autotune_cfg)
        self.stats = {
            "submitted": 0,
            "served": 0,
            "shed_served": 0,  # answers downgraded to approx (or conflicted)
            "conflicts": 0,  # recommender recall/latency conflicts seen
            "batches": 0,  # formed batches dispatched
            "deadline_flushes": 0,  # batches flushed below the top rung
            "full_flushes": 0,  # batches formed at the top rung
            "batch_hist": {},  # formed (real) batch size -> count
            "shed_transitions": 0,  # enter/exit events of the shed state
        }
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        name="gateway-dispatch", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------ client API
    def submit(self, q, *, k: Optional[int] = None,
               window: Optional[tuple] = None,
               target_recall: Optional[float] = None,
               latency_budget_ms: Optional[float] = None) -> Ticket:
        """Enqueue one query; returns immediately with a ``Ticket`` unless
        the bounded admission queue is full (then blocks — backpressure)."""
        q = np.asarray(q, np.float32).reshape(-1)
        req = _Request(q=q, k=int(k if k is not None else self.cfg.k),
                       window=None if window is None else
                       (int(window[0]), int(window[1])),
                       target_recall=target_recall,
                       latency_budget_ms=latency_budget_ms,
                       t_arrive=time.perf_counter(), ticket=Ticket())
        with self._cond:
            while len(self._queue) >= self.cfg.max_queue and not self._closed:
                self._cond.wait(0.01)
            if self._closed:
                raise RuntimeError("gateway is closed")
            self._queue.append(req)
            self.stats["submitted"] += 1
            self._cond.notify_all()
        return req.ticket

    def prewarm(self, caps, *, dtype: Optional[str] = None) -> int:
        """Register every (batch rung x table bucket) pass signature the
        dispatcher can form, so steady-state serving runs with zero
        retraces; on CUDA the kernel library is built here. ``caps`` —
        table sizes the stream will reach (the engine dedupes them onto its
        capacity rungs). The engine is the index's own device's: a CPU
        index never asks for the card."""
        eng = get_engine(self._idx.cfg.device)
        d = int(self._idx.cfg.summarization.series_len)
        n = 0
        for rung in ladder(self.cfg.max_batch):
            n += eng.prewarm(d, rung, self.cfg.k, list(caps), dtype=dtype)
        return n

    def snapshot(self) -> GatewayStats:
        """Typed point-in-time snapshot of the gateway counters, rolling
        percentiles, and (when autotuning) the tuner's loop counters."""
        # gather tuner counters BEFORE taking self._cond: the tuner has
        # its own lock and must never nest inside the gateway's
        tc = self.tuner.counters() if self.tuner is not None else {}
        with self._cond:
            st = self.stats
            lat = np.array(self._lat_ms, np.float64)
            return GatewayStats(
                submitted=st["submitted"], served=st["served"],
                shed_served=st["shed_served"], conflicts=st["conflicts"],
                batches=st["batches"],
                deadline_flushes=st["deadline_flushes"],
                full_flushes=st["full_flushes"],
                shed_transitions=st["shed_transitions"],
                batch_hist=dict(st["batch_hist"]),
                queue_depth=len(self._queue), shedding=self._shedding,
                p50_ms=float(np.percentile(lat, 50)) if lat.size else 0.0,
                p99_ms=float(np.percentile(lat, 99)) if lat.size else 0.0,
                autotune=self.tuner is not None,
                tuner_decisions=tc.get("decisions", 0),
                tuner_explores=tc.get("explores", 0),
                tuner_observations=tc.get("observations", 0),
                tuner_probes=tc.get("probes", 0))

    def snapshot_stats(self) -> dict:
        """Dict view of :meth:`snapshot` (back-compat for existing
        callers; same keys, ``batch_hist`` keeps its int keys)."""
        return dataclasses.asdict(self.snapshot())

    def reset_slo_window(self, timeout: float = 300.0) -> None:
        """Drop the rolling latency window and leave the shed state, once
        every request admitted so far is accounted.

        Warm-up traffic pays one-time costs (the first arena uploads, the
        kernel build without a prewarm) whose latencies would otherwise sit
        in the p99 window (``lat_window`` completions) and keep the shed
        gate engaged long into steady state — at low arrival rates the
        window can take the whole run to wash out. Harnesses that measure
        steady state (``serve.py --gateway``) call this once after draining
        their warm-up requests.

        A formed batch adds its latencies to the window only after its
        tuner shadow work, which runs after its tickets resolve. So the
        reset first waits (up to ``timeout`` seconds, then raises
        ``TimeoutError``) until the dispatcher has accounted every admitted
        request: reset as soon as the last warm-up ticket resolves, the
        window would refill with that batch and shed the first measured
        one. (The reference gateway resets at once and has that race.)"""
        end = time.perf_counter() + timeout
        with self._cond:
            while self._settled < self.stats["submitted"]:
                rem = end - time.perf_counter()
                if rem <= 0:
                    raise TimeoutError(
                        f"{self.stats['submitted'] - self._settled} admitted "
                        "requests still unaccounted")
                self._cond.wait(rem)
            self._lat_ms.clear()
            if self._shedding:
                self._shedding = False
                self.stats["shed_transitions"] += 1

    def close(self, timeout: float = 30.0) -> None:
        """Stop admitting, drain the queue, stop the dispatcher."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout)

    # ------------------------------------------------------------ dispatcher
    def _dispatch_loop(self) -> None:
        while True:
            formed = self._form_batch()
            if formed is None:
                return
            batch, shed_now = formed
            if not batch:
                continue
            try:
                self._serve_batch(batch, shed_now)
            except BaseException as e:  # resolve, or clients hang forever
                for req in batch:
                    req.ticket._resolve(err=e)
                with self._cond:
                    self._settled += len(batch)
                    self._cond.notify_all()

    def _form_batch(self):
        """Block until a batch is ready: either the top rung fills or the
        oldest request's deadline expires (then flush whatever is queued).
        Returns None when closed and drained."""
        cfg = self.cfg
        with self._cond:
            while not self._queue and not self._closed:
                self._cond.wait()
            if not self._queue:
                return None  # closed and drained
            deadline = self._queue[0].t_arrive + cfg.deadline_ms / 1e3
            while len(self._queue) < cfg.max_batch and not self._closed:
                rem = deadline - time.perf_counter()
                if rem <= 0:
                    break
                self._cond.wait(rem)
                if not self._queue:
                    return None if self._closed else ([], False)
            take = min(len(self._queue), cfg.max_batch)
            batch = [self._queue.popleft() for _ in range(take)]
            self.stats["batches"] += 1
            key = "full_flushes" if take >= cfg.max_batch else "deadline_flushes"
            self.stats[key] += 1
            hist = self.stats["batch_hist"]
            hist[take] = hist.get(take, 0) + 1
            shed_now = self._shedding
            self._cond.notify_all()  # free space for blocked submitters
        return batch, shed_now

    def _route(self, req: _Request, shed_now: bool, *, epoch: int,
               n_series: int):
        """(tier, n_blocks, shed, conflict, tune) for one request —
        ``tune`` is the ``(WorkloadKey, Knobs)`` pair to feed back to the
        tuner after serving (None on the static path). Strictly-exact
        requests (target_recall >= 1.0) are never shed; a conflict (the
        latency cap makes the recall target unreachable) marks the answer
        shed even when not under SLO pressure — it already cost the
        client its recall target."""
        tr, lb = req.target_recall, req.latency_budget_ms
        strict = tr is not None and tr >= 1.0
        tune = None
        if tr is None and lb is None:
            tier, nb, conflict = "exact", 0, False
        elif self.tuner is not None:
            wkey = workload_key(
                target_recall=tr, latency_budget_ms=lb, k=req.k,
                window=req.window, batch_rung=self.cfg.max_batch)
            rec = self.tuner.decide(wkey, epoch=epoch, n_series=n_series)
            tier, nb, conflict = rec.knobs.tier, rec.knobs.n_blocks, \
                rec.conflict
            tune = (wkey, rec.knobs, rec.shadow)
        else:
            dec = self._tier_decision(tr, lb)
            tier, nb, conflict = dec.tier, dec.n_blocks, dec.conflict
        shed = conflict
        if shed_now and tier == "exact" and not strict:
            tier, nb, shed = "approx", self.cfg.shed_n_blocks, True
            if tune is not None:
                # observations must credit the arm actually served; the
                # shed serve preempts any exploration shadow
                tune = (tune[0], Knobs("approx", nb), None)
        return tier, nb, shed, conflict, tune

    def _tier_decision(self, tr, lb) -> TierDecision:
        """Cached recommender serving-tier call. The live entry count is
        quantized to its power-of-two bucket so the cache stays small and
        decisions stay stable while ingest grows the store."""
        n_live = max(1024, int(self._idx.raw.n))
        n_q = 1 << (n_live - 1).bit_length()
        key = (tr, lb, n_q)
        with self._cond:
            dec = self._tier_cache.get(key)
        if dec is None:
            dec = serving_tier(Scenario(
                streaming=True, n_series=n_q,
                series_len=int(self._idx.cfg.summarization.series_len),
                uses_windows=True, target_recall=tr, latency_budget_ms=lb,
                query_batch=self.cfg.max_batch))
            with self._cond:
                self._tier_cache[key] = dec
        return dec

    def _query_group(self, tier: str, nb: int, Qg, kk: int, window, snap):
        """One engine pass for a padded sub-batch -> (vals, gids)."""
        if tier == "approx":
            if window is None:
                vals, gids, _ = self._idx.knn_approx_batch(
                    Qg, k=kk, n_blocks=max(nb, 1), snapshot=snap)
            else:
                vals, gids, _ = self._idx.window_knn_approx_batch(
                    Qg, window[0], window[1], k=kk, n_blocks=max(nb, 1),
                    snapshot=snap)
        elif window is None:
            vals, gids, _ = self._idx.knn_batch(Qg, k=kk, snapshot=snap)
        else:
            vals, gids, _ = self._idx.window_knn_batch(
                Qg, window[0], window[1], k=kk, snapshot=snap)
        return vals, gids

    def _serve_batch(self, batch, shed_now: bool) -> None:
        t_dispatch = time.perf_counter()
        # ONE pinned epoch for the whole formed batch: every sub-batch
        # answers against the same immutable snapshot even while background
        # ingest publishes new epochs mid-serve. Routing happens INSIDE the
        # pin so tuner decisions are stamped with the epoch they serve.
        with self._idx.pin() as snap:
            epoch = int(snap.epoch)
            n_series = max(1024, int(self._idx.raw.n))
            groups: dict = {}
            routed = []
            for i, req in enumerate(batch):
                tier, nb, shed, conflict, tune = self._route(
                    req, shed_now, epoch=epoch, n_series=n_series)
                routed.append((tier, nb, shed, conflict, tune))
                groups.setdefault((tier, nb, req.k, req.window),
                                  []).append(i)
            n_shed = n_conflict = 0
            lat_done = []
            served = []  # (key, idxs, Qg, gids, dt_ms) for shadow work
            # deterministic sub-batch order: mixed-tenant batches always
            # split and serve the same way for the same inputs
            for key in sorted(groups, key=lambda t: (t[0], t[1], t[2],
                                                     t[3] or (-1, -1))):
                tier, nb, kk, window = key
                idxs = groups[key]
                Qg = np.stack([batch[i].q for i in idxs])
                rung = _bucket_batch(len(idxs))
                if rung > len(idxs):
                    # pad to the rung floor with copies of a real query;
                    # prewarmed signatures make this retrace-free and the
                    # rows are sliced off below — padding never leaks
                    Qg = np.concatenate(
                        [Qg, np.repeat(Qg[:1], rung - len(idxs), axis=0)])
                t0 = time.perf_counter()
                vals, gids = self._query_group(tier, nb, Qg, kk, window,
                                               snap)
                t_grp = time.perf_counter()
                dt_ms = (t_grp - t0) * 1e3
                # resolve this sub-batch's tickets NOW: a slower later
                # group — or the shadow probe/exploration work below —
                # never inflates these clients' latency
                for row_, i in enumerate(idxs):
                    req = batch[i]
                    shed, conflict = routed[i][2], routed[i][3]
                    n_shed += int(shed)
                    n_conflict += int(conflict)
                    lat = (t_grp - req.t_arrive) * 1e3
                    lat_done.append(lat)
                    req.ticket._resolve(Response(
                        vals=vals[row_], ids=gids[row_], tier_served=tier,
                        n_blocks=nb, shed=shed, conflict=conflict,
                        queue_wait_ms=(t_dispatch - req.t_arrive) * 1e3,
                        latency_ms=lat, batch_size=len(batch),
                        padded_to=rung, epoch=epoch))
                served.append((key, idxs, Qg, gids, dt_ms))
            feedback = self._shadow_work(served, routed, batch, snap) \
                if self.tuner is not None else []
        # feed outcomes back OUTSIDE the pin (and outside self._cond): the
        # tuner has its own lock
        for wkey, knobs, lat_ms, recall, was_served in feedback:
            self.tuner.observe(wkey, knobs, lat_ms=lat_ms, epoch=epoch,
                               recall=recall, n_series=n_series,
                               served=was_served)
        with self._cond:
            self.stats["served"] += len(batch)
            self.stats["shed_served"] += n_shed
            self.stats["conflicts"] += n_conflict
            self._lat_ms.extend(lat_done)
            self._update_shed_locked()
            self._settled += len(batch)
            self._cond.notify_all()  # wake a reset waiting for the batch

    def _shadow_work(self, served, routed, batch, snap):
        """Post-resolution tuner measurements for one formed batch ->
        ``(wkey, knobs, lat_ms, recall, served)`` observations —
        ``served`` is False for exploration shadows (arms the client was
        not served), so trace consumers can score client-facing quality.

        Runs AFTER every client ticket is resolved, still inside the pin:
        recall probes (shadow exact on probed approx sub-batches) and
        exploration shadows (the bandit's explored arm re-served on the
        same padded sub-batch, timed, never returned to a client). All
        shadow I/O runs unaccounted so the cost model only ever charges
        work a client's answer needed. Padding rows are excluded from
        every recall average."""
        feedback = []
        for key, idxs, Qg, gids, dt_ms in served:
            tier, nb, kk, window = key
            tuned = [routed[i][4] for i in idxs if routed[i][4] is not None]
            if not tuned:
                continue
            n_real = len(idxs)
            exact_gids = gids if tier == "exact" else None
            recall = 1.0 if tier == "exact" else None
            if tier == "approx" and self.tuner.should_probe(tuned[0][0],
                                                            tuned[0][1]):
                with self._idx.raw.disk.unaccounted():
                    _, exact_gids = self._query_group("exact", 0, Qg, kk,
                                                      window, snap)
                recall = float(recall_at_k(gids[:n_real],
                                           exact_gids[:n_real]))
            for wkey, knobs, _shadow in tuned:
                feedback.append((wkey, knobs, dt_ms, recall, True))
            # exploration shadows: measure each explored arm on the same
            # padded sub-batch (prewarmed signatures keep it retrace-free);
            # recall is scored when an exact reference is already in hand
            for wkey, _knobs, shadow in tuned:
                if shadow is None:
                    continue
                t0 = time.perf_counter()
                with self._idx.raw.disk.unaccounted():
                    _, s_gids = self._query_group(
                        shadow.tier, shadow.n_blocks, Qg, kk, window, snap)
                s_dt_ms = (time.perf_counter() - t0) * 1e3
                if shadow.tier == "exact":
                    s_recall = 1.0
                elif exact_gids is not None:
                    s_recall = float(recall_at_k(s_gids[:n_real],
                                                 exact_gids[:n_real]))
                else:
                    s_recall = None
                feedback.append((wkey, shadow, s_dt_ms, s_recall, False))
        return feedback

    def _update_shed_locked(self) -> None:
        """Recompute the shed state from the rolling p99 (caller holds the
        lock). Hysteresis: enter above ``slo_p99_ms``, exit only below
        ``shed_exit_frac * slo_p99_ms`` so the state does not flap."""
        if len(self._lat_ms) < self.cfg.min_shed_samples:
            return
        p99 = float(np.percentile(np.array(self._lat_ms, np.float64), 99))
        if not self._shedding and p99 > self.cfg.slo_p99_ms:
            self._shedding = True
            self.stats["shed_transitions"] += 1
        elif self._shedding and p99 < self.cfg.shed_exit_frac * self.cfg.slo_p99_ms:
            self._shedding = False
            self.stats["shed_transitions"] += 1
