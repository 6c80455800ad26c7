"""Batch feature store — the paper's "daily job" (§III-A).

Materializes per-user fixed-length watch-history features from the event
log on a fixed cadence (default: midnight). Between snapshots the features
are served *statically* — exactly the staleness the paper's injection
closes.

Features are model-ready padded arrays:

    items (U, K) int32   — watch history, right-aligned ascending time
    ts    (U, K) int32   — event timestamps (same layout)
    valid (U, K) int32   — 1 where a real event occupies the slot

``K = feature_len``. Snapshots are versioned by timestamp; the store
materializes the newest ``snapshot_retention`` generations (default 8 —
``None`` keeps all, the seed behavior) and recomputes older registered
generations from the log on demand, so time-travel reads keep working
without production-scale memory growth.

The event log is the columnar ``EventLog`` (core/event_log.py):
``run_snapshot`` and ``lookup_at_cutoff`` are single vectorized windowed
gathers — no Python-level per-user loop anywhere on the hot path. The
retired loop implementation lives in ``core/_reference.py`` and the two
are differentially tested to be bit-for-bit identical.
"""
from __future__ import annotations

import bisect
import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.event_log import EventLog

DAY = 86400

Features = Tuple[np.ndarray, np.ndarray, np.ndarray]  # items, ts, valid


def _row_diff(prev_feats: Features, new_feats: Features, users: np.ndarray,
              chunk: int = 65536) -> np.ndarray:
    """Rows among ``users`` whose (items, ts, valid) triples differ
    bitwise between two frozen feature planes. Chunked so the compare
    never allocates a population-scale temporary — the same exact-diff
    primitive the background builder runs off-thread and the synchronous
    certification path runs inside the rollover clock call."""
    pi, pt, pv = prev_feats
    ni, nt, nv = new_feats
    users = np.asarray(users, np.int64)
    diffs = []
    for s in range(0, len(users), chunk):
        h = users[s:s + chunk]
        d = ((ni[h] != pi[h]) | (nt[h] != pt[h])
             | (nv[h] != pv[h])).any(axis=1)
        diffs.append(h[d])
    return np.concatenate(diffs) if diffs else users


@dataclasses.dataclass(frozen=True)
class FeatureStoreConfig:
    n_users: int
    feature_len: int = 64
    snapshot_period: int = DAY      # "daily" job cadence
    snapshot_offset: int = 0        # job runs at midnight by default
    window: int = 30 * DAY          # history lookback of the daily job
    # keep at most this many materialized generations (None = keep all).
    # Each generation is (n_users, K)x3 int32, so unbounded retention is
    # a memory leak at production scale and a cold store's catch-up would
    # burst-materialize every boundary since the first event; evicted or
    # skipped generations stay registered and are recomputed from the log
    # on the (rare) time-travel read that still wants them. Caveat: a
    # recompute reads the log as of NOW, so events that arrived late (old
    # ts, appended after the generation ran) are included where the frozen
    # arrays would not have had them.
    snapshot_retention: Optional[int] = 8
    # EventLog tiering (None = legacy unbounded append-only log). With
    # ``log_window`` set the store's log becomes the tiered sliding-
    # window store: hot tail + per-window compacted segments + eviction
    # past ``log_window * log_retention_windows``. ``log_segment_k``
    # defaults to ``feature_len`` — the compaction keep-depth must be at
    # least the materialize depth for the bitwise-exactness contract
    # (docs/event_log.md). ``log_hot_budget`` caps hot-tail capacity in
    # events. Whoever owns the clock (the Gateway's tick) must drive
    # ``log.compact``.
    log_window: Optional[int] = None
    log_retention_windows: int = 8
    log_segment_k: Optional[int] = None
    log_hot_budget: Optional[int] = None


class BatchFeatureStore:
    """Append-only event log + periodic snapshot materialization."""

    def __init__(self, cfg: FeatureStoreConfig):
        self.cfg = cfg
        self._log = EventLog(
            cfg.n_users, window=cfg.log_window,
            retention_windows=cfg.log_retention_windows,
            segment_k=(cfg.log_segment_k if cfg.log_segment_k is not None
                       else cfg.feature_len),
            hot_budget=cfg.log_hot_budget)
        # snapshot_ts -> (items, ts, valid) arrays
        self._snapshots: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        self._snapshot_times: List[int] = []
        # log length when each frozen generation was installed — the
        # "appended since" anchor incremental builds use to catch
        # late-arriving events (old ts, appended after the build)
        self._snapshot_log_n: Dict[int, int] = {}
        # snapshot_ts -> (prev_snapshot_ts, exact changed-user array):
        # rows that are bitwise different from the previous frozen
        # generation. This is the warm-handoff authority (a cached
        # prefill state keyed to the previous generation is still valid
        # for every user NOT in this set). The array may be None —
        # "adjacent and frozen, diff not yet computed": a synchronous
        # full build defers the full-plane row compare to the first
        # changed_users_between call so a handoff-disabled deployment
        # never pays it (incremental builds compute it eagerly from the
        # delta hint, which is cheap).
        self._changed_vs_prev: Dict[int, Tuple[int, Optional[np.ndarray]]] = {}

    # ------------------------------------------------------------------
    # Ingest (the offline log collector — sees everything, eventually)
    # ------------------------------------------------------------------
    def append(self, user: int, item: int, ts: int) -> None:
        self._log.append(user, item, ts)

    def extend(self, users, items, ts) -> None:
        """Columnar bulk ingest (parallel arrays)."""
        self._log.extend(users, items, ts)

    def append_events(self, events) -> None:
        for ev in events:
            self._log.append(ev.user, ev.item, ev.ts)

    # ------------------------------------------------------------------
    # The daily job
    # ------------------------------------------------------------------
    def run_snapshot(self, snapshot_ts: int) -> None:
        """Materialize features from all events with ts < snapshot_ts.

        This is the full-build oracle: one monolithic materialization of
        every user. The incremental path (:class:`SnapshotBuilder`, via
        ``begin_snapshot``) produces bit-for-bit identical arrays while
        only recomputing the changed-user delta.
        """
        c = self.cfg
        users = np.arange(c.n_users, dtype=np.int64)
        feats = self._log.materialize(
            users, snapshot_ts - c.window, snapshot_ts, c.feature_len)
        self._install(snapshot_ts, feats)

    def begin_snapshot(self, snapshot_ts: int) -> "SnapshotBuilder":
        """Start an incremental build of the ``snapshot_ts`` generation.

        Returns a :class:`SnapshotBuilder` whose budget-bounded ``step()``
        the caller drives (e.g. ``Gateway.tick`` between panes); the
        generation registers only when the build completes, so serving
        keeps reading the previous generation with no stall."""
        return SnapshotBuilder(self, snapshot_ts)

    def begin_snapshot_background(
            self, snapshot_ts: int,
            step_hook: Optional[Callable[[], None]] = None,
            chunk: Optional[int] = None) -> "BackgroundSnapshotBuilder":
        """Start an off-thread build of the ``snapshot_ts`` generation.

        Returns a :class:`BackgroundSnapshotBuilder` whose worker thread
        does the copy-forward and delta materialization against a frozen
        ``EventLog.view()``; the caller drives ``poll()`` (O(1) while the
        worker runs) and the generation installs atomically on the
        *calling* thread once the worker finishes. Bit-for-bit equal to
        ``run_snapshot`` at install time, same as the synchronous
        builder. ``step_hook`` (tests) is invoked by the worker after
        every chunk; ``chunk`` overrides the worker chunk size."""
        return BackgroundSnapshotBuilder(self, snapshot_ts,
                                         step_hook=step_hook, chunk=chunk)

    def _install(self, snapshot_ts: int, feats: Features,
                 delta_hint: Optional[np.ndarray] = None,
                 changed_rows: Optional[np.ndarray] = None) -> None:
        """Register a fully-materialized generation: record the changed-
        row delta vs the previous frozen generation (the warm-handoff
        authority), stamp the log length, insert into the timeline, evict
        past retention.

        ``delta_hint`` (from an incremental build) restricts the row
        compare to the rows that were rematerialized — every other row is
        a copy-forward of the previous generation and bitwise equal by
        construction — and the diff is computed eagerly. Without a hint
        (synchronous full build) only an adjacency marker is recorded and
        the full-plane compare is deferred to the first
        ``changed_users_between`` call. ``changed_rows`` supersedes both:
        a caller-certified changed set (exact or a conservative superset
        — the ``changed_users_between`` contract allows extra members)
        recorded verbatim, used by the background builder which computes
        the row diff off-thread so install itself stays O(changed)."""
        if snapshot_ts in self._snapshot_times:
            # idempotent re-run (e.g. run_snapshot called twice): replace
            # arrays and drop every delta record the re-materialization
            # un-certifies — this generation's own record AND any
            # successor's record that named it as predecessor (the old
            # diff was computed against the arrays being replaced)
            self._snapshots[snapshot_ts] = feats
            self._snapshot_log_n[snapshot_ts] = self._log.n_events
            self._changed_vs_prev.pop(snapshot_ts, None)
            for ts, rec in list(self._changed_vs_prev.items()):
                if rec[0] == snapshot_ts:
                    self._changed_vs_prev.pop(ts)
            return
        prev = self.latest_snapshot_ts(snapshot_ts - 1)
        if prev is not None and prev in self._snapshots:
            if changed_rows is not None:
                changed = np.asarray(changed_rows, np.int64)
            elif delta_hint is None:
                # synchronous full build: defer the full-plane row
                # compare to the first changed_users_between call (it is
                # ~0.75 GB of traversal at 1M users — the legacy
                # boundary stall must not grow for deployments that
                # never read the record)
                changed = None
            else:
                changed = _row_diff(self._snapshots[prev], feats,
                                    delta_hint)
            self._changed_vs_prev[snapshot_ts] = (prev, changed)
        self._snapshots[snapshot_ts] = feats
        self._snapshot_log_n[snapshot_ts] = self._log.n_events
        self._register_time(snapshot_ts)
        if self.cfg.snapshot_retention is not None:
            while len(self._snapshots) > self.cfg.snapshot_retention:
                evicted = min(self._snapshots)
                self._snapshots.pop(evicted)
                self._snapshot_log_n.pop(evicted, None)
                self._changed_vs_prev.pop(evicted, None)

    def changed_users_between(self, gen_a: int, gen_b: int,
                              ) -> Optional[np.ndarray]:
        """The exact set of users whose feature rows differ bitwise
        between generations ``gen_a`` and ``gen_b``, or ``None`` when no
        such set can be certified. A user absent from the returned set
        has bitwise-identical rows at both generations — the property
        the warm handoff's rekey rests on. (The contract tolerates
        supersets — extra members only cost unnecessary invalidations —
        but every certification path now row-diffs down to the exact
        set, including the synchronous-build path, which used to hand
        back the raw log-scan superset.)

        Certification requires (1) a recorded adjacency: ``gen_b`` was
        installed with ``gen_a`` as its immediate predecessor (a
        multi-generation gap returns ``None`` — compose it yourself if
        you must), and (2) **both generations still frozen**: an evicted
        generation recomputes from the log *as of now* on lookup, so
        state derived from it after eviction (e.g. a prefill cached
        during a legacy clock rewind) is not necessarily a function of
        the frozen rows the record compared — the warm handoff must not
        rekey across it."""
        rec = self._changed_vs_prev.get(gen_b)
        if rec is None or rec[0] != gen_a:
            return None
        if gen_a not in self._snapshots or gen_b not in self._snapshots:
            return None
        if rec[1] is None:
            # synchronous build: no exact delta was recorded. Scan the
            # log for the conservative superset (entering / aging-out /
            # appended-since-gen_a's-build — the same criterion the
            # incremental builder's copy-forward proof rests on), then
            # row-diff just those rows between the two frozen planes —
            # the background worker's exact-diff primitive. One columnar
            # pass plus an O(superset) compare, still far cheaper than a
            # full-plane compare, and the result is EXACT: a sync
            # rollover invalidates no more users than an incremental one
            if gen_a not in self._snapshot_log_n:
                return None
            superset = self._log.changed_users(
                gen_a, gen_b, self.cfg.window,
                since=self._snapshot_log_n[gen_a])
            changed = _row_diff(self._snapshots[gen_a],
                                self._snapshots[gen_b], superset)
            self._changed_vs_prev[gen_b] = (gen_a, changed)
            return changed
        return rec[1]

    def _register_time(self, snapshot_ts: int) -> None:
        bisect.insort(self._snapshot_times, snapshot_ts)

    def latest_due_boundary(self, now: int) -> int:
        """The newest snapshot boundary at or before ``now`` on the
        period/offset grid — the generation a fully caught-up store
        serves at ``now``."""
        c = self.cfg
        return ((now - c.snapshot_offset) // c.snapshot_period) \
            * c.snapshot_period + c.snapshot_offset

    def maybe_run_due_snapshots(self, now: int) -> None:
        """Run every snapshot whose scheduled time has passed (idempotent).

        Catch-up is complete: after a gap of several periods, each missed
        boundary is materialized in order. With no prior snapshot, catch-up
        starts at the first period boundary after the earliest logged event
        (earlier snapshots would be all-zero; if the log is empty only the
        most recent boundary runs, registering an empty generation).
        With ``snapshot_retention`` set, boundaries that would be evicted
        immediately are registered without building their arrays.
        """
        c = self.cfg
        latest_due = self.latest_due_boundary(now)
        if self._snapshot_times:
            start = self._snapshot_times[-1] + c.snapshot_period
        elif len(self._log):
            first = self._log.min_ts()
            start = ((first - c.snapshot_offset) // c.snapshot_period + 1) \
                * c.snapshot_period + c.snapshot_offset
        else:
            start = latest_due
        while start < 0:  # stay on the offset grid (defensive: ts >= 0)
            start += c.snapshot_period
        for due in range(start, latest_due + 1, c.snapshot_period):
            if c.snapshot_retention is not None and due <= latest_due \
                    - c.snapshot_retention * c.snapshot_period:
                self._register_time(due)
            else:
                self.run_snapshot(due)

    @property
    def log(self) -> EventLog:
        """The underlying append-only event log. Exposed read-only by
        convention: external consumers (the online trainer) take
        lock-free frozen ``view()`` captures; all writes still go
        through the store's ingest methods."""
        return self._log

    # ------------------------------------------------------------------
    # Serving reads
    # ------------------------------------------------------------------
    def latest_snapshot_ts(self, now: int) -> Optional[int]:
        i = bisect.bisect_right(self._snapshot_times, now) - 1
        return self._snapshot_times[i] if i >= 0 else None

    def lookup(self, users: np.ndarray, now: int,
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Batch features as served at wall-time ``now`` (latest snapshot
        at or before now). Zero features if no snapshot exists yet."""
        snap = self.latest_snapshot_ts(now)
        k = self.cfg.feature_len
        if snap is None:
            z = np.zeros((len(users), k), np.int32)
            return z, z.copy(), z.copy()
        if snap not in self._snapshots:  # evicted generation: recompute
            return self.lookup_at_cutoff(users, snap)
        items, ts_arr, valid = self._snapshots[snap]
        return items[users], ts_arr[users], valid[users]

    def snapshot_rows(self, gen: int, users: np.ndarray,
                      ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                          np.ndarray]]:
        """Feature rows of a specific **frozen** generation, or ``None``
        when ``gen`` is not materialized (evicted generations recompute
        from the live log, which is exactly what the delta-re-warm
        prefix check must not trust). Rows come straight out of the
        frozen arrays, so they are bitwise what serving read at that
        generation."""
        if gen not in self._snapshots:
            return None
        items, ts_arr, valid = self._snapshots[gen]
        return items[users], ts_arr[users], valid[users]

    def lookup_at_cutoff(self, users: np.ndarray, cutoff: int,
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Features computed directly with an arbitrary cutoff (used by the
        training-data builder and the latency ablation — it emulates a
        feature pipeline whose refresh latency places the cutoff at
        ``cutoff`` rather than last midnight)."""
        c = self.cfg
        return self._log.materialize(
            np.asarray(users), cutoff - c.window, cutoff, c.feature_len)

    # ------------------------------------------------------------------
    def user_events(self, user: int) -> List[Tuple[int, int]]:
        return self._log.user_events(user)


# ----------------------------------------------------------------------
# Incremental snapshot builds
# ----------------------------------------------------------------------

class SnapshotBuilder:
    """Amortized, delta-only materialization of one snapshot generation.

    ``run_snapshot`` re-materializes the full ``(n_users, feature_len)``
    plane in one synchronous call (~1-3 s at 1M users on the benchmark
    host) — a stall the serving loop cannot hide when the daily boundary
    falls inside a ``submit``/``tick``. The builder splits that work:

    * **delta only** — the changed-user set between the previous frozen
      generation and ``snapshot_ts`` (``EventLog.changed_users``: events
      entering ``[prev, ts)``, events aging out of the lookback window,
      late arrivals appended since the previous build) is rematerialized;
      every other row is **copy-forwarded** from the previous
      generation's frozen arrays.
    * **budget-bounded** — ``step(budget)`` advances the build by at
      most ``budget`` rows per call (copy-forward slabs first, then
      delta materializations) and returns the remaining count, so a
      caller (``Gateway.tick``) can interleave build slices between
      serving panes. Even the copy-forward is chunked: the previous
      generation is ~0.75 GB at 1M users, a creation-time stall if
      copied monolithically.
    * **bit-for-bit** — the finished arrays are identical to what
      ``run_snapshot(snapshot_ts)`` would produce *at completion time*:
      a finish-time fixup rematerializes any user whose in-window events
      were appended mid-build, and the copy-forward rows are provably
      equal (a non-changed user's window event set is identical at both
      cutoffs). Differentially tested in tests/test_rollover.py,
      including the aging-out and mid-build-append cases.

    The generation registers (and serving's ``generation(now)`` rolls)
    only when the last step installs the arrays — until then every read
    keeps serving the previous generation, which is exactly the paper's
    "served statically throughout the day" semantics extended to the
    build window. Falls back to a full build (delta = every user) when
    there is no previous frozen generation to delta against.
    """

    def __init__(self, store: BatchFeatureStore, snapshot_ts: int):
        if snapshot_ts in store._snapshot_times:
            raise ValueError(
                f"generation {snapshot_ts} is already registered")
        self.store = store
        self.snapshot_ts = int(snapshot_ts)
        c = store.cfg
        self._n0 = store._log.n_events  # log length at build start
        prev = store.latest_snapshot_ts(snapshot_ts - 1)
        self.prev = prev
        self.full_build = (prev is None or prev not in store._snapshots
                           or prev not in store._snapshot_log_n)
        shape = (c.n_users, c.feature_len)
        if self.full_build:
            self._todo = np.arange(c.n_users, dtype=np.int64)
            self._items = np.zeros(shape, np.int32)
            self._ts = np.zeros(shape, np.int32)
            self._valid = np.zeros(shape, np.int32)
            self._copy_n = 0          # nothing to copy-forward
        else:
            self._todo = store._log.changed_users(
                prev, snapshot_ts, c.window,
                since=store._snapshot_log_n[prev])
            # copy-forward happens CHUNKED inside step(), not here: at
            # 1M users the previous generation is ~0.75 GB of arrays,
            # and one monolithic .copy() would be a creation-time stall
            # as bad as the build this class exists to amortize
            self._items = np.empty(shape, np.int32)
            self._ts = np.empty(shape, np.int32)
            self._valid = np.empty(shape, np.int32)
            self._copy_n = c.n_users  # rows to copy-forward (all rows;
            #                           delta fills overwrite changed)
        self._copy_pos = 0
        self._pos = 0
        self.done = False
        self.steps = 0
        self.step_time_s = 0.0
        self.late_fixups = 0

    # ------------------------------------------------------------------
    @property
    def n_changed(self) -> int:
        """Users this build rematerializes (== n_users for a full build)."""
        return len(self._todo)

    @property
    def remaining(self) -> int:
        """Rows of work left: copy-forward rows + delta users."""
        if self.done:
            return 0
        return (self._copy_n - self._copy_pos) + (len(self._todo)
                                                  - self._pos)

    # ------------------------------------------------------------------
    def _fill(self, users: np.ndarray) -> None:
        c = self.store.cfg
        it, t, v = self.store._log.materialize(
            users, self.snapshot_ts - c.window, self.snapshot_ts,
            c.feature_len)
        self._items[users] = it
        self._ts[users] = t
        self._valid[users] = v

    def step(self, budget: int) -> int:
        """One budget-bounded slice of the build: first copy-forward up
        to ``budget`` contiguous rows from the previous generation, then
        (once the copy is done) materialize up to ``budget`` changed
        users per call; install the generation when both phases are
        exhausted. Returns the rows of work remaining (0 once
        installed)."""
        if self.done:
            return 0
        t0 = time.perf_counter()
        budget = max(int(budget), 1)
        if self._copy_pos < self._copy_n:
            a = self._copy_pos
            b = min(a + budget, self._copy_n)
            pi, pt, pv = self.store._snapshots[self.prev]
            self._items[a:b] = pi[a:b]
            self._ts[a:b] = pt[a:b]
            self._valid[a:b] = pv[a:b]
            self._copy_pos = b
        else:
            chunk = self._todo[self._pos:self._pos + budget]
            if len(chunk):
                self._fill(chunk)
                self._pos += len(chunk)
        if self._copy_pos >= self._copy_n and self._pos >= len(self._todo):
            self._finish()
        self.steps += 1
        self.step_time_s += time.perf_counter() - t0
        return self.remaining

    def run(self) -> None:
        """Drain the whole build in one call (the synchronous oracle
        path, minus the delta savings)."""
        while not self.done:
            self.step(max(self.remaining, 1))

    def _finish(self) -> None:
        c = self.store.cfg
        # fixup: users whose in-window events were appended while the
        # build was in flight (any ts inside the new window — including
        # late arrivals with old timestamps) — rematerialize them so the
        # installed arrays equal run_snapshot() as of *now*
        late = self.store._log.users_with_events(
            self.snapshot_ts - c.window, self.snapshot_ts, start=self._n0)
        if len(late):
            self._fill(late)
            self.late_fixups = len(late)
        hint = None if self.full_build else np.union1d(self._todo, late)
        self.store._install(self.snapshot_ts,
                            (self._items, self._ts, self._valid),
                            delta_hint=hint)
        self.done = True


class BackgroundSnapshotBuilder:
    """Off-thread incremental build with an atomic on-thread install.

    The synchronous :class:`SnapshotBuilder` amortizes the build into
    budget-bounded ``step()`` slices, but every slice still runs *on the
    serving thread*: heavy traffic starves the build and the worst slice
    (59 ms at 1M users in BENCH_rollover.json) stalls whichever clock
    call pays it. This class moves the whole build onto a dedicated
    daemon thread and shrinks the serving thread's involvement to O(1)
    ``poll()`` calls plus one O(changed) finalize:

    * **double-buffered feature plane** — the worker owns a private
      ``(n_users, feature_len)×3`` buffer (the same copy-forward layout
      as the synchronous builder; at 1M users that is ~0.75 GB held
      *alongside* the live generation for the build's duration — the
      memory cost of backgrounding). Serving keeps reading the previous
      generation's arrays untouched until install.
    * **narrow-lock delta reads** — the worker never touches the owning
      log's mutable indexes: it captures an immutable
      ``EventLog.view()`` (O(1), taken under the log's write lock) and
      computes the changed-user set, chunked copy-forward, and delta
      fills against that frozen prefix. NumPy releases the GIL for the
      bulk array work, so the copy genuinely overlaps serving.
    * **install handshake** — the worker only builds; it never installs.
      All log *writes* and the finalize live on the calling (serving)
      thread: ``poll()`` notices the worker finished, rematerializes
      users whose in-window events were appended mid-build (the same
      finish-time fixup as the synchronous builder, against the full
      live log — exact because appends are single-threaded on the
      caller's side), and registers the generation via the store's
      single atomic ``_install`` point. Until that moment
      ``generation(now)`` keeps returning the previous generation.
    * **pre-certified handoff delta** — the worker also row-diffs its
      rematerialized rows against the previous generation off-thread, so
      install passes an exact-∪-late ``changed_rows`` set and the
      serving thread never pays the diff (or the deferred log-scan) that
      would otherwise ride the rollover clock call.

    Worker exceptions are sticky: re-raised from ``poll()``/``join()``.
    ``step_hook`` (tests only) runs on the worker after every chunk —
    a barrier there gives deterministic interleaving.
    """

    CHUNK = 65536  # worker chunk: bounds each slice of copy/fill work

    def __init__(self, store: BatchFeatureStore, snapshot_ts: int,
                 step_hook: Optional[Callable[[], None]] = None,
                 chunk: Optional[int] = None):
        if snapshot_ts in store._snapshot_times:
            raise ValueError(
                f"generation {snapshot_ts} is already registered")
        self.store = store
        self.snapshot_ts = int(snapshot_ts)
        self._chunk = max(int(chunk), 1) if chunk else self.CHUNK
        self._step_hook = step_hook
        c = store.cfg
        # captured on the calling thread so the worker never reads the
        # store's mutable dicts: log anchor, predecessor arrays, since
        self._n0 = store._log.n_events
        prev = store.latest_snapshot_ts(snapshot_ts - 1)
        self.prev = prev
        self.full_build = (prev is None or prev not in store._snapshots
                           or prev not in store._snapshot_log_n)
        self._prev_feats = (None if self.full_build
                            else store._snapshots[prev])
        self._since = (0 if self.full_build
                       else store._snapshot_log_n[prev])
        shape = (c.n_users, c.feature_len)
        alloc = np.zeros if self.full_build else np.empty
        self._items = alloc(shape, np.int32)
        self._ts = alloc(shape, np.int32)
        self._valid = alloc(shape, np.int32)
        # worker progress (plain ints/arrays: GIL-atomic rebinds; read
        # cross-thread only as a progress estimate)
        self._todo: Optional[np.ndarray] = None
        self._changed_exact: Optional[np.ndarray] = None
        self._copy_n = 0 if self.full_build else c.n_users
        self._copy_pos = 0
        self._pos = 0
        self.done = False
        self.steps = 0                 # worker chunks processed
        self.step_time_s = 0.0         # worker busy time + finalize
        self.late_fixups = 0
        self._error: Optional[BaseException] = None
        self._built = threading.Event()
        self._thread = threading.Thread(
            target=self._work, name=f"snapshot-build-{snapshot_ts}",
            daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    @property
    def n_changed(self) -> int:
        """Users the build rematerializes (estimate 0 until the worker's
        delta scan lands; exact afterwards)."""
        todo = self._todo
        return len(todo) if todo is not None else 0

    @property
    def remaining(self) -> int:
        """Rows of build work left (progress estimate while the worker
        runs; 0 only once the generation is installed)."""
        if self.done:
            return 0
        todo = self._todo
        todo_left = (len(todo) - self._pos if todo is not None
                     else self.store.cfg.n_users)
        return max((self._copy_n - self._copy_pos) + todo_left, 1)

    # ------------------------------------------------------------------
    # worker side: build only — never writes the log, never installs
    # ------------------------------------------------------------------
    def _work(self) -> None:
        try:
            t0 = time.perf_counter()
            view = self.store._log.view()
            c = self.store.cfg
            lo = self.snapshot_ts - c.window
            if self.full_build:
                todo = np.arange(c.n_users, dtype=np.int64)
            else:
                todo = view.changed_users(self.prev, self.snapshot_ts,
                                          c.window, since=self._since)
            self._todo = todo
            self._tick(t0)
            # chunked copy-forward of the previous generation
            while self._copy_pos < self._copy_n:
                t0 = time.perf_counter()
                a = self._copy_pos
                b = min(a + self._chunk, self._copy_n)
                pi, pt, pv = self._prev_feats
                self._items[a:b] = pi[a:b]
                self._ts[a:b] = pt[a:b]
                self._valid[a:b] = pv[a:b]
                self._copy_pos = b
                self._tick(t0)
            # chunked delta fills against the frozen view
            while self._pos < len(todo):
                t0 = time.perf_counter()
                chunk = todo[self._pos:self._pos + self._chunk]
                it, t, v = view.materialize(chunk, lo, self.snapshot_ts,
                                            c.feature_len)
                self._items[chunk] = it
                self._ts[chunk] = t
                self._valid[chunk] = v
                self._pos += len(chunk)
                self._tick(t0)
            # pre-certify the handoff delta: row-diff the rematerialized
            # rows against the previous generation, off-thread
            if not self.full_build and len(todo):
                t0 = time.perf_counter()
                self._changed_exact = _row_diff(
                    self._prev_feats, (self._items, self._ts, self._valid),
                    todo, chunk=self._chunk)
                self._tick(t0)
            elif not self.full_build:
                self._changed_exact = todo
        except BaseException as e:  # sticky: re-raised from poll/join
            self._error = e
        finally:
            self._built.set()

    def _tick(self, t0: float) -> None:
        self.step_time_s += time.perf_counter() - t0
        self.steps += 1
        if self._step_hook is not None:
            self._step_hook()

    # ------------------------------------------------------------------
    # caller side: O(1) poll, O(changed) finalize, atomic install
    # ------------------------------------------------------------------
    def poll(self) -> int:
        """Non-blocking advance: returns remaining work (>0 while the
        worker runs). When the worker has finished, runs the finish-time
        fixup and installs the generation — after which ``done`` is True
        and 0 is returned. Re-raises a worker exception, stickily."""
        if self.done:
            return 0
        if self._error is not None:
            raise RuntimeError(
                f"background build of generation {self.snapshot_ts} "
                f"failed") from self._error
        if not self._built.is_set():
            return self.remaining
        self._finalize()
        return 0

    def join(self, timeout: Optional[float] = None) -> int:
        """Block until the worker finishes (or ``timeout`` elapses),
        then finalize+install on this thread. Returns remaining work
        (0 once installed)."""
        self._built.wait(timeout)
        return self.poll()

    def _finalize(self) -> None:
        t0 = time.perf_counter()
        c = self.store.cfg
        # finish-time fixup, same contract as SnapshotBuilder._finish:
        # any user whose in-window events were appended after build
        # start is rematerialized from the LIVE log — exact, because
        # appends only happen on this thread
        late = self.store._log.users_with_events(
            self.snapshot_ts - c.window, self.snapshot_ts, start=self._n0)
        if len(late):
            it, t, v = self.store._log.materialize(
                late, self.snapshot_ts - c.window, self.snapshot_ts,
                c.feature_len)
            self._items[late] = it
            self._ts[late] = t
            self._valid[late] = v
            self.late_fixups = len(late)
        changed = (None if self.full_build
                   else np.union1d(self._changed_exact, late))
        self.store._install(self.snapshot_ts,
                            (self._items, self._ts, self._valid),
                            changed_rows=changed)
        self.done = True
        self.step_time_s += time.perf_counter() - t0
