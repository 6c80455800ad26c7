"""Columnar event log — the shared feature-plane backbone, now a tiered
sliding-window store with bounded memory.

The per-user Python lists the seed used for both the batch store and the
realtime service cap simulations at toy user counts: every snapshot was a
Python loop over users, every lookup a list comprehension per row. This
module replaces them with a struct-of-arrays design:

* three flat columns (``user``, ``item``, ``ts``) with amortized-doubling
  growth — O(1) append, O(m) columnar extend;
* a per-user CSR-style index over a sorted **base** prefix (one
  ``np.lexsort`` by ``(user, ts, item)`` plus ``searchsorted`` row
  offsets), rebuilt lazily and only when the unsorted **pending** suffix
  outgrows a fraction of the base. Reads that race interleaved writes —
  the serving loop's ``observe``/``lookup`` pattern — sort just the small
  pending suffix and merge per queried row, so a lookup never pays a
  full-log re-sort.

An append-only log is a memory leak at production ingest rates, so the
log optionally **tiers** (pass ``window=...``):

* **hot tail** — the columnar SoA above, holding every event at or past
  the compaction horizon (plus any suffix protected by ``keep_from``),
  with its capacity bounded by ``hot_budget``;
* **warm segments** — one immutable, window-compacted segment per
  elapsed time window of length ``window``: the freshest ``segment_k``
  events per user, ``(user, ts, item)``-sorted with their own CSR index
  and the *absolute append position* of every kept event;
* **cold eviction** — segments whose window falls entirely below
  ``horizon - retention_windows * window`` are dropped.

``compact(now)`` moves fully-elapsed windows out of the tail (the open
window never compacts, which is the natural late-arrival grace period).
An append whose ``ts`` is already below the horizon is **demoted**
straight into its window's segment — or, past the retention floor,
dropped; both are counted in ``counters``, never silently lost. A
``keep_from`` append position (the online trainer's cursor) pins the
not-yet-consumed suffix in the hot tail across compaction.

Positions are **absolute**: every append consumes one position for the
lifetime of the log, ``n_events`` counts positions (not retained rows),
and segments remember each kept event's position — so position-anchored
delta scans (``users_with_events(..., start=log_n_at_build)``, the
rollover late-arrival certification) and the trainer's
``events_since(cursor)`` survive compaction.

**Exactness contract** (see docs/event_log.md): a query window
``[lo, hi)`` is bitwise-identical to an unbounded log when ``lo`` is at
or above the retention floor, ``k <= segment_k``, and ``hi`` does not
split a compacted window (``hi`` above the horizon or window-aligned).
Queries that do split a compacted window are exact unless that window
trimmed events (a user held more than ``segment_k`` events in one
window); user-set scans then degrade to a recorded **superset** — the
safe direction for ``changed_users`` — via each segment's trim
bookkeeping.

Both stores match the retired loop implementations
(``core/_reference.py``) bit-for-bit; see tests/test_feature_plane_diff.py.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

Features = Tuple[np.ndarray, np.ndarray, np.ndarray]  # items, ts, valid


def sort_window_right_align(items: np.ndarray, ts: np.ndarray,
                            vis: np.ndarray, k: int, ts_dtype=np.int32,
                            ) -> Features:
    """Row-wise: sort the visible ``(ts, item)`` pairs ascending, keep the
    freshest ``k`` per row, right-align into (m, k) padded arrays.

    items/ts (m, w) int64 scratch panes, vis (m, w) bool. The composite
    int64 sort key pushes invisible slots to the left; stable argsort
    preserves arrival order among exact duplicates.
    """
    m = items.shape[0]
    out_i = np.zeros((m, k), np.int32)
    out_t = np.zeros((m, k), ts_dtype)
    out_v = np.zeros((m, k), np.int32)
    if m == 0 or not vis.any():
        return out_i, out_t, out_v
    t0 = ts[vis].min()
    i0 = items[vis].min()
    iscale = int(items[vis].max()) - int(i0) + 1
    key = np.where(vis, (ts - t0) * iscale + (items - i0), -1)
    order = np.argsort(key, axis=1, kind="stable")
    ts = np.take_along_axis(ts, order, axis=1)
    items = np.take_along_axis(items, order, axis=1)
    w = items.shape[1]
    if k <= w:
        ts, items = ts[:, w - k:], items[:, w - k:]
    else:
        pad = ((0, 0), (k - w, 0))
        ts, items = np.pad(ts, pad), np.pad(items, pad)
    keep = np.minimum(vis.sum(axis=1), k)
    mask = np.arange(k)[None, :] >= (k - keep)[:, None]
    out_i[mask] = items[mask]
    out_t[mask] = ts[mask].astype(ts_dtype)
    out_v[mask] = 1
    return out_i, out_t, out_v


def _scatter_right_aligned(order, item_col, ts_col, a, counts, k,
                           items, ts_out, valid):
    """Scatter CSR ranges [a, a+counts) (already (ts, item)-sorted) into
    right-aligned (m, k) outputs. Pure gathers — no per-row loop."""
    total = int(counts.sum())
    if total == 0:
        return
    rows = np.repeat(np.arange(len(counts)), counts)
    offs = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    src = order[np.repeat(a, counts) + offs]
    cols = k - np.repeat(counts, counts) + offs
    items[rows, cols] = item_col[src]
    ts_out[rows, cols] = ts_col[src].astype(ts_out.dtype)
    valid[rows, cols] = 1


class _SortedIndex:
    """(user, ts, item)-sorted CSR over a column slice + composite key."""

    def __init__(self, users, items, ts):
        self.order = np.lexsort((items, ts, users))
        us = users[self.order]
        tss = ts[self.order]
        self.ts_min = int(ts.min()) if len(ts) else 0
        ts_max = int(ts.max()) if len(ts) else 0
        self.scale = ts_max - self.ts_min + 2
        self.key = us * self.scale + (tss - self.ts_min)

    def window(self, users, lo, hi, k):
        """Per queried user: CSR range of the freshest <=k events with
        lo <= ts < hi. Returns (a, counts) into ``self.order``."""
        qlo = users * self.scale + np.clip(lo - self.ts_min, 0,
                                           self.scale - 1)
        qhi = users * self.scale + np.clip(hi - self.ts_min, 0,
                                           self.scale - 1)
        a = np.searchsorted(self.key, qlo, side="left")
        b = np.searchsorted(self.key, qhi, side="left")
        a = np.maximum(a, b - k)
        return a, b - a


# ----------------------------------------------------------------------
# warm tier: immutable window-compacted segments
# ----------------------------------------------------------------------

class _Segment:
    """One compacted time window ``[w0, w1)``: the freshest ``<=k``
    events per user, ``(user, ts, item)``-sorted, with each kept event's
    absolute append position. Immutable once built — merging late events
    rebuilds the segment (copy-on-write), so a captured reference stays
    consistent forever."""

    __slots__ = ("w0", "w1", "user", "item", "ts", "pos", "index", "n",
                 "nbytes", "ts_min", "max_pos", "trimmed", "trim_users",
                 "trim_ts_lo", "trim_ts_hi", "trim_pos_hi")

    def scan_users(self, lo: int, hi: int, start: int) -> List[np.ndarray]:
        """User arrays for ``users_with_events`` over this segment:
        exact presence from the kept rows, plus the trim superset when
        the query could have matched a trimmed (older-than-kept) event —
        i.e. the query right edge splits this window, or the scan is
        position-anchored past trimmed positions."""
        out: List[np.ndarray] = []
        m = (self.ts >= lo) & (self.ts < hi)
        if start > 0:
            m &= self.pos >= start
        if m.any():
            out.append(np.unique(self.user[m]))
        if self.trimmed and (hi < self.w1 or start > 0) \
                and lo <= self.trim_ts_hi and self.trim_ts_lo < hi \
                and start <= self.trim_pos_hi:
            out.append(self.trim_users)
        return out


def _build_segment(w0: int, w1: int, user, item, ts, pos, k: int,
                   prev: Optional[_Segment] = None) -> _Segment:
    """Compact candidate rows (append order) — merged with an existing
    segment's kept rows when ``prev`` is given — into a fresh segment:
    ``(user, ts, item)``-lexsort, keep the freshest ``k`` per user group,
    fold the cut rows into the trim bookkeeping."""
    if prev is not None:
        user = np.concatenate([prev.user, np.asarray(user, np.int64)])
        item = np.concatenate([prev.item, np.asarray(item, np.int32)])
        ts = np.concatenate([prev.ts, np.asarray(ts, np.int64)])
        pos = np.concatenate([prev.pos, np.asarray(pos, np.int64)])
    else:
        user = np.asarray(user, np.int64)
        item = np.asarray(item, np.int32)
        ts = np.asarray(ts, np.int64)
        pos = np.asarray(pos, np.int64)
    order = np.lexsort((item, ts, user))
    us, its = user[order], item[order]
    tss, ps = ts[order], pos[order]
    n = len(us)
    # freshest k per user group == last k rows of each (user,ts,item)
    # run; lexsort is stable so full-duplicate ties keep append order
    new_grp = np.empty(n, bool)
    new_grp[0] = True
    new_grp[1:] = us[1:] != us[:-1]
    starts = np.flatnonzero(new_grp)
    counts = np.diff(np.append(starts, n))
    gidx = np.cumsum(new_grp) - 1
    ends = (starts + counts)[gidx]
    keep = (ends - 1 - np.arange(n)) < k
    seg = _Segment()
    seg.w0, seg.w1 = int(w0), int(w1)
    seg.user, seg.item = us[keep], its[keep]
    seg.ts, seg.pos = tss[keep], ps[keep]
    seg.n = int(keep.sum())
    seg.index = _SortedIndex(seg.user, seg.item, seg.ts)
    seg.ts_min = int(seg.ts.min())
    seg.max_pos = int(seg.pos.max())
    cut = n - seg.n
    if cut:
        cut_ts, cut_pos = tss[~keep], ps[~keep]
        cut_users = np.unique(us[~keep])
        if prev is not None and prev.trimmed:
            seg.trim_users = np.union1d(prev.trim_users, cut_users)
            seg.trim_ts_lo = min(prev.trim_ts_lo, int(cut_ts.min()))
            seg.trim_ts_hi = max(prev.trim_ts_hi, int(cut_ts.max()))
            seg.trim_pos_hi = max(prev.trim_pos_hi, int(cut_pos.max()))
        else:
            seg.trim_users = cut_users
            seg.trim_ts_lo = int(cut_ts.min())
            seg.trim_ts_hi = int(cut_ts.max())
            seg.trim_pos_hi = int(cut_pos.max())
        seg.trimmed = (prev.trimmed if prev is not None else 0) + cut
    elif prev is not None and prev.trimmed:
        seg.trimmed = prev.trimmed
        seg.trim_users = prev.trim_users
        seg.trim_ts_lo, seg.trim_ts_hi = prev.trim_ts_lo, prev.trim_ts_hi
        seg.trim_pos_hi = prev.trim_pos_hi
    else:
        seg.trimmed = 0
        seg.trim_users = np.empty(0, np.int64)
        seg.trim_ts_lo = seg.trim_ts_hi = 0
        seg.trim_pos_hi = -1
    seg.nbytes = int(seg.user.nbytes + seg.item.nbytes + seg.ts.nbytes
                     + seg.pos.nbytes + seg.trim_users.nbytes)
    return seg


def _compose_blocks(blocks, users, lo, hi, k, ts_dtype,
                    items, ts_out, valid) -> Features:
    """Materialize across tier blocks: each block (a sorted index + its
    columns) contributes its own freshest-``k`` window slice to a scratch
    pane; one final row-wise merge keeps exact top-``k``-of-union
    semantics (blocks partition the events, so the union's freshest k is
    always inside the union of per-block freshest k). Pane layout is
    segments-ascending-then-tail, which matches append order for ties —
    and identical ``(ts, item)`` duplicates produce identical output bits
    regardless of which physical copy survives."""
    m = len(users)
    nb = len(blocks)
    pane_i = np.zeros((m, nb * k), np.int64)
    pane_t = np.zeros((m, nb * k), np.int64)
    pane_v = np.zeros((m, nb * k), bool)
    for j, (idx, item_col, ts_col) in enumerate(blocks):
        a, counts = idx.window(users, lo, hi, k)
        sl = slice(j * k, (j + 1) * k)
        _scatter_right_aligned(idx.order, item_col, ts_col, a, counts, k,
                               pane_i[:, sl], pane_t[:, sl], pane_v[:, sl])
    if not pane_v.any():
        return items, ts_out, valid
    return sort_window_right_align(pane_i, pane_t, pane_v, k, ts_dtype)


def _users_with_events(user, ts, pos, n, segments, lo, hi, start,
                       ) -> np.ndarray:
    """Shared composite scan: hot-tail columns (position-anchored via the
    pos column when tiered, by index otherwise) plus every overlapping
    warm segment."""
    parts: List[np.ndarray] = []
    if n:
        if pos is None:
            i0 = min(start, n)
        else:
            i0 = int(np.searchsorted(pos[:n], start))
        if i0 < n:
            w = ts[i0:n]
            m = (w >= lo) & (w < hi)
            if m.any():
                parts.append(np.unique(user[i0:n][m]))
    for seg in segments:
        if seg.w0 < hi and seg.w1 > lo:
            parts.extend(seg.scan_users(lo, hi, start))
    if not parts:
        return np.empty(0, np.int64)
    if len(parts) == 1:
        return parts[0]
    return np.unique(np.concatenate(parts))


# ----------------------------------------------------------------------
# compaction plan: capture -> build (pure, off-thread-safe) -> install
# ----------------------------------------------------------------------

def _compact_build(plan: Dict, segment_k: int) -> Dict:
    """Pure build phase of a compaction: from a captured tail prefix,
    produce the new segment map and the new hot-tail arrays. Touches no
    log state, so it can run on a worker thread (the captured column
    prefixes are immutable — growth reallocates, never resizes)."""
    n = plan["n"]
    window = plan["window"]
    horizon, floor = plan["horizon"], plan["floor"]
    user, item = plan["user"][:n], plan["item"][:n]
    ts, pos = plan["ts"][:n], plan["pos"][:n]
    keep = ts >= horizon
    if plan["keep_from"] is not None:
        # pin the trainer's unconsumed suffix in the hot tail: those
        # rows can neither be trimmed nor evicted before consumption
        keep |= pos >= plan["keep_from"]
    moved = ~keep
    evict = moved & (ts < floor)
    to_seg = moved & ~evict
    counters = {"compacted": int(to_seg.sum()), "evicted": int(evict.sum()),
                "trimmed": 0}
    segments: Dict[int, _Segment] = {}
    for w0, seg in plan["segments"].items():
        if seg.w1 <= floor:
            counters["evicted"] += seg.n
        else:
            segments[w0] = seg
    if to_seg.any():
        su, si = user[to_seg], item[to_seg]
        st, sp = ts[to_seg], pos[to_seg]
        wids = st // window
        for w in np.unique(wids):
            wm = wids == w
            w0 = int(w) * window
            prev = segments.get(w0)
            seg = _build_segment(w0, w0 + window, su[wm], si[wm], st[wm],
                                 sp[wm], segment_k, prev=prev)
            counters["trimmed"] += seg.trimmed - (prev.trimmed if prev
                                                  else 0)
            segments[w0] = seg
    kept = int(keep.sum())
    cap = 16
    while cap < kept:
        cap *= 2
    if plan["hot_budget"] is not None and cap > plan["hot_budget"]:
        cap = max(plan["hot_budget"], kept)
    nu = np.empty(cap, np.int64)
    ni = np.empty(cap, np.int32)
    nt = np.empty(cap, np.int64)
    npos = np.empty(cap, np.int64)
    nu[:kept] = user[keep]
    ni[:kept] = item[keep]
    nt[:kept] = ts[keep]
    npos[:kept] = pos[keep]
    return {"plan": plan, "segments": segments, "counters": counters,
            "user": nu, "item": ni, "ts": nt, "pos": npos, "kept": kept}


class EventLog:
    """Columnar (user, item, ts) log with a lazy base index, a sort-free
    pending suffix merged at read time, and (when ``window`` is set) the
    tiered sliding-window machinery described in the module docstring.
    Untiered (``window=None``) behavior is identical to the historical
    append-only log.

    Threading model: one writer thread (``append``/``extend``/
    ``compact``); any number of reader threads via ``view()``. The
    narrow ``_lock`` only makes captures tear-free — reads on the owning
    thread stay lock-free."""

    # full rebuild when pending > max(MIN_REBUILD, base/8)
    MIN_REBUILD = 4096

    def __init__(self, n_users: int, capacity: int = 1024,
                 window: Optional[int] = None, retention_windows: int = 8,
                 segment_k: int = 64, hot_budget: Optional[int] = None):
        self.n_users = int(n_users)
        self.window = int(window) if window else None
        self.retention_windows = int(retention_windows)
        self.segment_k = int(segment_k)
        self.hot_budget = int(hot_budget) if hot_budget else None
        cap = max(int(capacity), 16)
        if self.hot_budget is not None:
            cap = min(cap, max(self.hot_budget, 16))
        self._user = np.empty(cap, np.int64)
        self._item = np.empty(cap, np.int32)
        self._ts = np.empty(cap, np.int64)
        # absolute append position per hot row (tiered only)
        self._pos = np.empty(cap, np.int64) if self.window else None
        self._n = 0
        self._appended = 0        # positions consumed, ever
        self._segments: Dict[int, _Segment] = {}
        self._compact_horizon: Optional[int] = None
        self._retained_floor: Optional[int] = None
        self._compacting = False  # off-thread build in flight
        self._late_buffer: List[Tuple[int, int, int, int]] = []
        self.counters = {"demoted": 0, "dropped_late": 0, "trimmed": 0,
                         "evicted": 0, "compacted": 0, "compactions": 0,
                         "hot_overflow": 0}
        self._base_n = 0          # events covered by _base
        self._base: _SortedIndex = None
        self._tail: _SortedIndex = None
        self._tail_span = (0, 0)  # (base_n, n) the cached tail covers
        # narrow write lock: guards the (columns, _n) pair so a
        # concurrent ``view()`` never captures a half-written append.
        # Reads on the owning thread stay lock-free — the lock is only
        # taken for the O(1)/O(m) column writes and the O(1) capture.
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    # writes
    # ------------------------------------------------------------------
    def __len__(self) -> int:
        """Retained events (hot tail + warm segments)."""
        return self._n + sum(s.n for s in self._segments.values())

    @property
    def n_events(self) -> int:
        """Absolute append positions consumed — monotone across
        compaction, so snapshot anchors and trainer cursors stay valid
        after the tail is rewritten. Equals ``len(self)`` untiered."""
        return self._appended

    def _grow(self, need: int) -> None:
        cap = len(self._user)
        if self._n + need <= cap:
            return
        new = cap
        while new < self._n + need:
            new *= 2
        if self.hot_budget is not None and new > self.hot_budget:
            # bounded hot tail: never allocate doubling headroom past
            # the window budget; a burst that genuinely exceeds it still
            # lands (in-window events are never refused) but is counted
            new = max(self.hot_budget, self._n + need)
            if self._n + need > self.hot_budget:
                self.counters["hot_overflow"] += 1
        names = ["_user", "_item", "_ts"]
        if self._pos is not None:
            names.append("_pos")
        for name in names:
            arr = getattr(self, name)
            out = np.empty(new, arr.dtype)
            out[:self._n] = arr[:self._n]
            setattr(self, name, out)

    def _route_late_locked(self, user: int, item: int, ts: int,
                           pos: int) -> None:
        """Demote one late event (ts below the compaction horizon)
        straight into its window's segment, or drop it past retention.
        Caller holds ``_lock``. Copy-on-write on the segment map so
        captured views stay consistent."""
        if ts < self._retained_floor:
            self.counters["dropped_late"] += 1
            return
        w0 = (ts // self.window) * self.window
        prev = self._segments.get(w0)
        seg = _build_segment(
            w0, w0 + self.window, np.asarray([user], np.int64),
            np.asarray([item], np.int32), np.asarray([ts], np.int64),
            np.asarray([pos], np.int64), self.segment_k, prev=prev)
        self.counters["trimmed"] += seg.trimmed - (prev.trimmed if prev
                                                   else 0)
        self.counters["demoted"] += 1
        new = dict(self._segments)
        new[w0] = seg
        self._segments = new

    def append(self, user: int, item: int, ts: int) -> None:
        if not 0 <= user < self.n_users:
            raise IndexError(f"user {user} out of range [0, {self.n_users})")
        with self._lock:
            p = self._appended
            self._appended = p + 1
            if self._compact_horizon is not None \
                    and ts < self._compact_horizon:
                if self._compacting:
                    # an off-thread build owns the segment map right
                    # now; park the event, installed drains the buffer
                    self._late_buffer.append((int(user), int(item),
                                              int(ts), p))
                else:
                    self._route_late_locked(int(user), int(item),
                                            int(ts), p)
                return
            self._grow(1)
            i = self._n
            self._user[i] = user
            self._item[i] = item
            self._ts[i] = ts
            if self._pos is not None:
                self._pos[i] = p
            self._n = i + 1

    def extend(self, users, items, ts) -> None:
        """Columnar bulk append (parallel arrays)."""
        users = np.asarray(users)
        m = len(users)
        if m == 0:
            return
        if users.min() < 0 or users.max() >= self.n_users:
            raise IndexError(
                f"user ids out of range [0, {self.n_users}): "
                f"[{users.min()}, {users.max()}]")
        items = np.asarray(items)
        ts = np.asarray(ts)
        with self._lock:
            p0 = self._appended
            self._appended = p0 + m
            pos = np.arange(p0, p0 + m, dtype=np.int64)
            if self._compact_horizon is not None:
                late = np.asarray(ts) < self._compact_horizon
                if late.any():
                    for j in np.flatnonzero(late):
                        row = (int(users[j]), int(items[j]), int(ts[j]),
                               int(pos[j]))
                        if self._compacting:
                            self._late_buffer.append(row)
                        else:
                            self._route_late_locked(*row)
                    hot = ~late
                    users, items = users[hot], items[hot]
                    ts, pos = ts[hot], pos[hot]
                    m = len(users)
                    if m == 0:
                        return
            self._grow(m)
            s = self._n
            self._user[s:s + m] = users
            self._item[s:s + m] = items
            self._ts[s:s + m] = ts
            if self._pos is not None:
                self._pos[s:s + m] = pos
            self._n = s + m

    def view(self) -> "LogView":
        """Frozen consistent snapshot of the log for cross-thread reads.

        Captures the column references, the current event count, and
        (tiered) the segment map under the write lock. The log is
        append-only in place — ``_grow`` copies into *fresh* arrays and
        ``compact`` swaps in *fresh* tail arrays and a *fresh* segment
        map (segments themselves are immutable) — so everything captured
        is stable no matter how many appends or compactions race it.
        O(1)-ish — no event data is copied.
        """
        with self._lock:
            # hand over the base index when it covers exactly the
            # captured prefix: _SortedIndex is immutable once built and
            # column prefixes survive _grow by content, so the view can
            # skip its own population-scale lexsort (which would hold
            # the GIL in long numpy sorts, stalling the capturing
            # thread's polls). A stale/partial base just means the view
            # sorts for itself on first materialize.
            base = self._base
            reuse = base if (base is not None
                             and len(base.order) == self._n) else None
            segs = None
            if self.window is not None:
                segs = tuple(sorted(self._segments.values(),
                                    key=lambda s: s.w0))
            return LogView(self._user, self._item, self._ts, self._n,
                           self.n_users, index=reuse, pos=self._pos,
                           segments=segs, appended=self._appended)

    # ------------------------------------------------------------------
    # compaction (tiered only)
    # ------------------------------------------------------------------
    def compaction_due(self, now: int) -> bool:
        """Cheap tick-time poll: has a new window boundary elapsed since
        the last compaction?"""
        if self.window is None:
            return False
        horizon = (int(now) // self.window) * self.window
        return self._compact_horizon is None or horizon > self._compact_horizon

    def _compact_capture(self, now: int, keep_from: Optional[int]
                         ) -> Optional[Dict]:
        """Phase 1 (under lock): snapshot everything the pure build
        phase needs. Marks the log ``_compacting`` so concurrent late
        appends buffer instead of racing the segment-map build."""
        if self.window is None:
            return None
        with self._lock:
            horizon = (int(now) // self.window) * self.window
            if self._compact_horizon is not None \
                    and horizon <= self._compact_horizon:
                return None
            if self._compacting:
                return None
            self._compacting = True
            return {"window": self.window, "horizon": horizon,
                    "floor": horizon - self.retention_windows * self.window,
                    "user": self._user, "item": self._item, "ts": self._ts,
                    "pos": self._pos, "n": self._n,
                    "keep_from": None if keep_from is None
                    else int(keep_from),
                    "hot_budget": self.hot_budget,
                    "segments": self._segments}

    def _compact_abort(self) -> None:
        with self._lock:
            buffered = self._late_buffer
            self._late_buffer = []
            self._compacting = False
            for row in buffered:
                self._route_late_locked(*row)

    def _compact_install(self, built: Dict) -> Dict:
        """Phase 3 (under lock, owner thread): swap in the new tail and
        segment map, carry over any rows appended since the capture, and
        drain late events buffered while the build was in flight."""
        plan = built["plan"]
        with self._lock:
            nu, ni = built["user"], built["item"]
            nt, npos = built["ts"], built["pos"]
            kept = built["kept"]
            extra = self._n - plan["n"]
            if extra > 0:
                # owner-thread appends raced an off-thread build: they
                # live past the captured prefix in the old arrays
                need = kept + extra
                if need > len(nu):
                    def _bigger(a):
                        out = np.empty(need, a.dtype)
                        out[:kept] = a[:kept]
                        return out
                    nu, ni, nt, npos = (_bigger(a) for a in
                                        (nu, ni, nt, npos))
                sl = slice(plan["n"], self._n)
                nu[kept:need] = self._user[sl]
                ni[kept:need] = self._item[sl]
                nt[kept:need] = self._ts[sl]
                npos[kept:need] = self._pos[sl]
                kept = need
            self._user, self._item, self._ts, self._pos = nu, ni, nt, npos
            self._n = kept
            self._segments = built["segments"]
            self._compact_horizon = plan["horizon"]
            self._retained_floor = plan["floor"]
            for key, v in built["counters"].items():
                self.counters[key] += v
            self.counters["compactions"] += 1
            self._base = None
            self._base_n = 0
            self._tail = None
            self._tail_span = (0, 0)
            buffered = self._late_buffer
            self._late_buffer = []
            self._compacting = False
            for row in buffered:
                self._route_late_locked(*row)
        return dict(built["counters"], horizon=plan["horizon"],
                    segments=len(built["segments"]), hot=kept)

    def compact(self, now: int, keep_from: Optional[int] = None,
                step_hook=None) -> Dict:
        """Synchronous compaction: move fully-elapsed windows out of the
        hot tail into per-window segments, evict past retention. No-op
        (empty dict) untiered or when no new window boundary elapsed.
        ``keep_from`` pins append positions ``>= keep_from`` in the tail
        (the trainer's unconsumed suffix). ``step_hook(phase)`` fires at
        phase boundaries — the concurrency batteries' barrier point."""
        plan = self._compact_capture(now, keep_from)
        if plan is None:
            return {}
        try:
            if step_hook:
                step_hook("captured")
            built = _compact_build(plan, self.segment_k)
            if step_hook:
                step_hook("built")
        except BaseException:
            self._compact_abort()
            raise
        out = self._compact_install(built)
        if step_hook:
            step_hook("installed")
        return out

    # ------------------------------------------------------------------
    # index maintenance
    # ------------------------------------------------------------------
    def _rebuild(self) -> None:
        n = self._n
        self._base = _SortedIndex(self._user[:n], self._item[:n],
                                  self._ts[:n])
        self._base_n = n

    def _ensure_base(self, n_queried: int) -> None:
        pending = self._n - self._base_n
        if self._base is None or pending > max(self.MIN_REBUILD,
                                               self._base_n // 8):
            self._rebuild()
        elif pending and n_queried >= max(1024, pending):
            # population-scale read racing a small pending suffix (e.g.
            # run_snapshot right after a serve wave): the merge path's
            # query-sized scratch panes would dwarf one amortized rebuild
            self._rebuild()

    def _tail_index(self) -> _SortedIndex:
        """Sorted index over the pending suffix, cached between writes."""
        span = (self._base_n, self._n)
        if self._tail_span != span:
            p0, n = span
            self._tail = _SortedIndex(self._user[p0:n], self._item[p0:n],
                                      self._ts[p0:n])
            self._tail_span = span
        return self._tail

    def min_ts(self) -> int:
        vals = [seg.ts_min for seg in self._segments.values()]
        if self._n:
            vals.append(int(self._ts[:self._n].min()))
        if not vals:
            raise ValueError("empty log has no min ts")
        return min(vals)

    def _overlapping(self, lo: int, hi: int) -> List[_Segment]:
        if not self._segments:
            return []
        return sorted((s for s in self._segments.values()
                       if s.w0 < hi and s.w1 > lo),
                      key=lambda s: s.w0)

    # ------------------------------------------------------------------
    # telemetry
    # ------------------------------------------------------------------
    def ingest_stats(self) -> Dict:
        """Memory + routing counters for GatewayStats: ``bytes_hot`` is
        the tail's allocated footprint, ``bytes_warm`` the segment sum.
        Conservation: ``appended == events_hot + events_warm + trimmed +
        dropped_late + evicted``."""
        segs = list(self._segments.values())
        bytes_hot = (self._user.nbytes + self._item.nbytes
                     + self._ts.nbytes
                     + (self._pos.nbytes if self._pos is not None else 0))
        return dict(self.counters,
                    window=self.window or 0,
                    retention_windows=self.retention_windows,
                    appended=int(self._appended),
                    events_hot=int(self._n),
                    events_warm=int(sum(s.n for s in segs)),
                    segments=len(segs),
                    bytes_hot=int(bytes_hot),
                    bytes_warm=int(sum(s.nbytes for s in segs)))

    # ------------------------------------------------------------------
    # delta queries (the incremental-snapshot backbone)
    # ------------------------------------------------------------------
    def users_with_events(self, lo: int, hi: int, start: int = 0,
                          ) -> np.ndarray:
        """Sorted unique users with >=1 event with ``lo <= ts < hi``
        among the events appended at log positions ``>= start``.

        One vectorized columnar scan over the hot tail — position-
        anchored through the pos column when tiered — plus every
        overlapping warm segment (kept rows scanned by position exactly;
        trimmed rows contribute their recorded superset, see
        ``_Segment.scan_users``). ``start`` lets a caller restrict the
        scan to events appended after a known point (e.g. "since the
        previous snapshot was built"), which is how late-arriving events
        with old timestamps are caught — including ones already demoted
        into a segment.
        """
        start = max(int(start), 0)
        if hi <= lo:
            return np.empty(0, np.int64)
        return _users_with_events(self._user, self._ts, self._pos,
                                  self._n, self._overlapping(lo, hi),
                                  lo, hi, start)

    def changed_users(self, prev_cutoff: int, new_cutoff: int, window: int,
                      since: int = 0) -> np.ndarray:
        """Users whose ``[cutoff - window, cutoff)`` event set may differ
        between snapshot cutoffs ``prev_cutoff`` and ``new_cutoff``:

        * events *entering* by timestamp — ts in ``[prev, new)``;
        * events *aging out* of the lookback window — ts in
          ``[prev - window, new - window)``;
        * *late arrivals* — events appended at log positions ``>= since``
          (pass the log length when the previous snapshot was built) whose
          ts already lands inside the new window: the previous snapshot
          cannot contain them no matter what their timestamp says.

        The result is a **superset** of the truly-changed users (an
        entering event can still materialize to identical features if it
        falls outside the freshest-``feature_len`` cut), which is the safe
        direction: rematerializing an unchanged user is wasted work, not
        wrong output. A user absent from this set has a bitwise-identical
        event window at both cutoffs.
        """
        entering = self.users_with_events(prev_cutoff, new_cutoff)
        aging = self.users_with_events(prev_cutoff - window,
                                       new_cutoff - window)
        late = self.users_with_events(new_cutoff - window, new_cutoff,
                                      start=since)
        return np.union1d(np.union1d(entering, aging), late)

    def user_events(self, user: int) -> List[Tuple[int, int]]:
        """(ts, item) pairs for one user, sorted — debug/compat helper."""
        pairs: List[Tuple[int, int]] = []
        for seg in sorted(self._segments.values(), key=lambda s: s.w0):
            idx = seg.index
            a = np.searchsorted(idx.key, np.int64(user) * idx.scale)
            b = np.searchsorted(idx.key, np.int64(user + 1) * idx.scale)
            rows = idx.order[a:b]
            pairs.extend((int(t), int(i)) for t, i in zip(seg.ts[rows],
                                                          seg.item[rows]))
        if self._n:
            if self._base is None or self._base_n != self._n:
                self._rebuild()
            base = self._base
            a = np.searchsorted(base.key, np.int64(user) * base.scale)
            b = np.searchsorted(base.key, np.int64(user + 1) * base.scale)
            idx = base.order[a:b]
            pairs.extend((int(t), int(i)) for t, i in zip(self._ts[idx],
                                                          self._item[idx]))
        pairs.sort()
        return pairs

    # ------------------------------------------------------------------
    # reads
    # ------------------------------------------------------------------
    def materialize(self, users, lo: int, hi: int, k: int,
                    ts_dtype=np.int32) -> Features:
        """Freshest ``k`` events with ``lo <= ts < hi`` per requested user,
        right-aligned ascending ``(ts, item)`` into (len(users), k) arrays.
        Composes warm segments with the hot tail when the query window
        reaches below the compaction horizon (exactness contract in the
        module docstring).
        """
        users = np.asarray(users, np.int64).ravel()
        m = len(users)
        items = np.zeros((m, k), np.int32)
        ts_out = np.zeros((m, k), ts_dtype)
        valid = np.zeros((m, k), np.int32)
        if m == 0 or hi <= lo:
            return items, ts_out, valid
        segs = self._overlapping(lo, hi) if self.window is not None else []
        if not segs:
            if self._n == 0:
                return items, ts_out, valid
            self._ensure_base(m)
            a, counts = self._base.window(users, lo, hi, k)
            if self._n == self._base_n:
                # fast path: everything indexed, one scatter
                _scatter_right_aligned(self._base.order, self._item,
                                       self._ts, a, counts, k, items,
                                       ts_out, valid)
                return items, ts_out, valid
            # merge path: sort only the small pending suffix (cached
            # between writes), combine per row
            p0 = self._base_n
            tail = self._tail_index()
            ta, tcounts = tail.window(users, lo, hi, k)
            # scratch pane: base block (<=k) | tail block (<=k), both
            # already (ts, item)-sorted; a row-wise merge-sort keeps
            # exact semantics (only the freshest k of each block can
            # survive the union's cut)
            pane_i = np.zeros((m, 2 * k), np.int64)
            pane_t = np.zeros((m, 2 * k), np.int64)
            pane_v = np.zeros((m, 2 * k), bool)
            _scatter_right_aligned(self._base.order, self._item, self._ts,
                                   a, counts, k, pane_i[:, :k],
                                   pane_t[:, :k], pane_v[:, :k])
            _scatter_right_aligned(tail.order, self._item[p0:self._n],
                                   self._ts[p0:self._n], ta, tcounts, k,
                                   pane_i[:, k:], pane_t[:, k:],
                                   pane_v[:, k:])
            return sort_window_right_align(pane_i, pane_t, pane_v, k,
                                           ts_dtype)
        blocks = [(s.index, s.item, s.ts) for s in segs]
        if self._n:
            self._ensure_base(m)
            blocks.append((self._base, self._item, self._ts))
            if self._n != self._base_n:
                p0 = self._base_n
                tail = self._tail_index()
                blocks.append((tail, self._item[p0:self._n],
                               self._ts[p0:self._n]))
        return _compose_blocks(blocks, users, lo, hi, k, ts_dtype,
                               items, ts_out, valid)


class BackgroundCompactor:
    """Off-thread compaction driver, mirroring the
    ``BackgroundSnapshotBuilder`` worker pattern: ``start(now)`` captures
    the plan under the log's lock and hands the pure build phase to a
    daemon worker; the owner thread calls ``poll()`` from its tick loop
    until the built plan is ready, then installs it atomically (one
    lock-held pointer swap). Worker errors are sticky and re-raised on
    the owner thread at the next ``poll()``."""

    def __init__(self, log: EventLog):
        self.log = log
        self._thread: Optional[threading.Thread] = None
        self._done = threading.Event()
        self._built: Optional[Dict] = None
        self._error: Optional[BaseException] = None
        self._step_hook = None

    @property
    def active(self) -> bool:
        return self._thread is not None

    def start(self, now: int, keep_from: Optional[int] = None,
              step_hook=None) -> bool:
        """Begin an off-thread compaction; False when nothing is due or
        one is already in flight."""
        if self._thread is not None:
            return False
        plan = self.log._compact_capture(now, keep_from)
        if plan is None:
            return False
        self._done.clear()
        self._built = None
        self._error = None
        self._step_hook = step_hook
        self._thread = threading.Thread(
            target=self._work, args=(plan,), daemon=True,
            name="event-log-compactor")
        self._thread.start()
        return True

    def _work(self, plan: Dict) -> None:
        try:
            if self._step_hook:
                self._step_hook("captured")
            self._built = _compact_build(plan, self.log.segment_k)
            if self._step_hook:
                self._step_hook("built")
        except BaseException as e:  # sticky — surfaces at next poll
            self._error = e
        finally:
            self._done.set()

    def poll(self) -> Optional[Dict]:
        """Non-blocking: install the finished build (returns its summary
        dict) or return None while the worker is still running / idle."""
        if self._thread is None or not self._done.is_set():
            return None
        self._thread.join()
        self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            self.log._compact_abort()
            raise RuntimeError("background compaction failed") from err
        built, self._built = self._built, None
        out = self.log._compact_install(built)
        if self._step_hook:
            self._step_hook("installed")
        return out

    def join(self, timeout: Optional[float] = None) -> None:
        t = self._thread
        if t is not None:
            t.join(timeout)


class LogView:
    """Immutable snapshot of an :class:`EventLog` for cross-thread reads
    while the owning thread keeps appending — and, tiered, keeps
    compacting.

    Captured by ``EventLog.view()``: column *references* plus the event
    count ``n`` at capture time, and the segment tuple when tiered.
    Because the log never mutates in place (growth reallocates,
    compaction swaps in fresh arrays and a fresh segment map, segments
    are immutable), nothing captured here can change — so the view needs
    no locking at all. It carries its own private :class:`_SortedIndex`
    (built lazily on first ``materialize``, or handed over by ``view()``
    when the log's base index already covers exactly the captured
    prefix — index objects are immutable once built) instead of touching
    the owning log's cached index *slots*, which are not thread-safe.
    """

    def __init__(self, user, item, ts, n: int, n_users: int,
                 index: _SortedIndex = None, pos=None, segments=None,
                 appended: Optional[int] = None):
        n = int(n)
        self._user = user[:n]
        self._item = item[:n]
        self._ts = ts[:n]
        self._pos = None if pos is None else pos[:n]
        self._segments: Tuple[_Segment, ...] = segments or ()
        self._n = n
        self._appended = int(appended) if appended is not None else n
        self.n_users = int(n_users)
        self._index: _SortedIndex = index

    def __len__(self) -> int:
        return self._n

    @property
    def n_events(self) -> int:
        """Absolute append positions at capture — the anchor a snapshot
        build or trainer cursor records (see ``EventLog.n_events``)."""
        return self._appended

    # same delta-query semantics as EventLog, against the frozen capture
    def users_with_events(self, lo: int, hi: int, start: int = 0,
                          ) -> np.ndarray:
        start = max(int(start), 0)
        if hi <= lo:
            return np.empty(0, np.int64)
        return _users_with_events(self._user, self._ts, self._pos,
                                  self._n, self._segments, lo, hi, start)

    def changed_users(self, prev_cutoff: int, new_cutoff: int, window: int,
                      since: int = 0) -> np.ndarray:
        entering = self.users_with_events(prev_cutoff, new_cutoff)
        aging = self.users_with_events(prev_cutoff - window,
                                       new_cutoff - window)
        late = self.users_with_events(new_cutoff - window, new_cutoff,
                                      start=since)
        return np.union1d(np.union1d(entering, aging), late)

    def events_since(self, start: int = 0,
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(user, item, ts)`` columns of the retained events appended
        at positions ``>= start`` within the capture, in append order —
        the online trainer's consume primitive: it remembers the
        position it has trained through and asks each fresh view only
        for the suffix. Untiered this is a zero-copy slice; tiered it
        additionally resurfaces late events already demoted into warm
        segments (merged back into position order), so compaction never
        makes the trainer skip a retained event. Events past retention
        (dropped or trimmed) are the only ones missing — callers can
        count them as ``(n_events - start) - len(returned)``."""
        start = max(int(start), 0)
        if self._pos is None:
            s = min(start, self._n)
            return (self._user[s:], self._item[s:], self._ts[s:])
        i0 = int(np.searchsorted(self._pos, start))
        parts = [(self._user[i0:], self._item[i0:], self._ts[i0:],
                  self._pos[i0:])]
        for seg in self._segments:
            if seg.max_pos >= start:
                m = seg.pos >= start
                parts.append((seg.user[m], seg.item[m], seg.ts[m],
                              seg.pos[m]))
        if len(parts) == 1:
            u, it, t, _ = parts[0]
            return (u, it, t)
        u = np.concatenate([p[0] for p in parts])
        it = np.concatenate([p[1] for p in parts])
        t = np.concatenate([p[2] for p in parts])
        p = np.concatenate([p[3] for p in parts])
        order = np.argsort(p, kind="stable")
        return (u[order], it[order], t[order])

    def materialize(self, users, lo: int, hi: int, k: int,
                    ts_dtype=np.int32) -> Features:
        """Identical output to ``EventLog.materialize`` restricted to the
        capture. The hot block is always the fully-indexed fast path —
        the view is frozen, so there is never a pending suffix to merge;
        tiered, overlapping warm segments compose in exactly as on the
        live log."""
        users = np.asarray(users, np.int64).ravel()
        m = len(users)
        items = np.zeros((m, k), np.int32)
        ts_out = np.zeros((m, k), ts_dtype)
        valid = np.zeros((m, k), np.int32)
        if m == 0 or hi <= lo:
            return items, ts_out, valid
        segs = [s for s in self._segments if s.w0 < hi and s.w1 > lo]
        if not segs:
            if self._n == 0:
                return items, ts_out, valid
            if self._index is None:
                self._index = _SortedIndex(self._user, self._item, self._ts)
            a, counts = self._index.window(users, lo, hi, k)
            _scatter_right_aligned(self._index.order, self._item, self._ts,
                                   a, counts, k, items, ts_out, valid)
            return items, ts_out, valid
        blocks = [(s.index, s.item, s.ts) for s in segs]
        if self._n:
            if self._index is None:
                self._index = _SortedIndex(self._user, self._item, self._ts)
            blocks.append((self._index, self._item, self._ts))
        return _compose_blocks(blocks, users, lo, hi, k, ts_dtype,
                               items, ts_out, valid)
