"""Real-time feature service — the paper's streaming job (§III-B, Fig. 2).

"A dedicated real-time feature service ... a continuous streaming job that
continuously consumes user behavior events and transforms them into
model-ready real-time watch history features with minimal delay."

The production version is a Kafka/Flink-style consumer; here it is an
in-process service with the same *semantics* (DESIGN.md §7.2):

* **ingest latency** — an event becomes visible ``ingest_latency`` seconds
  after it happened (stream propagation + processing delay);
* **bounded retention** — only a short window is kept (``retention``
  seconds, ``buffer_len`` events/user): "the real-time feature service ...
  can only maintain a short time range";
* **at-least-once** — duplicate deliveries are tolerated (the downstream
  merge deduplicates by item, so redelivery is harmless — property-tested).

Reads return fixed-shape padded arrays ready for the ``history_merge``
kernel: no dynamic shapes cross the host→device boundary.

Storage is a pair of columnar ``(n_users, buffer_len)`` ring arrays with a
per-user write cursor — the array-native form of the seed's per-user
deques: O(1) ingest, memory bounded by construction, and ``lookup`` is a
single vectorized gather + row-wise sort (no index to rebuild, so the
serving loop's interleaved observe/lookup pattern stays O(batch)). The
retired loop implementation lives in ``core/_reference.py`` and matches
bit-for-bit (differentially tested).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from repro_torch.core.event_log import sort_window_right_align


@dataclasses.dataclass(frozen=True)
class RealtimeConfig:
    n_users: int
    buffer_len: int = 16          # per-user ring buffer (events)
    ingest_latency: int = 30      # seconds from event to visibility
    retention: int = 86400        # short window the service maintains


class RealtimeFeatureService:
    """Columnar ring buffers over a simulated event stream."""

    def __init__(self, cfg: RealtimeConfig):
        self.cfg = cfg
        u, k = cfg.n_users, cfg.buffer_len
        self._items = np.zeros((u, k), np.int64)
        self._ts = np.zeros((u, k), np.int64)
        self._count = np.zeros(u, np.int64)   # total ever ingested per user
        self.events_ingested = 0

    # ------------------------------------------------------------------
    def ingest(self, user: int, item: int, ts: int) -> None:
        """Consume one stream event (idempotent under redelivery given the
        downstream dedup; buffer keeps duplicates — cheap, bounded)."""
        if not 0 <= user < self.cfg.n_users:
            raise IndexError(
                f"user {user} out of range [0, {self.cfg.n_users})")
        slot = self._count[user] % self.cfg.buffer_len
        self._items[user, slot] = item
        self._ts[user, slot] = ts
        self._count[user] += 1
        self.events_ingested += 1

    def extend(self, users, items, ts) -> None:
        """Columnar bulk ingest (parallel arrays, arrival order kept)."""
        users = np.asarray(users, np.int64).ravel()
        m = len(users)
        if m == 0:
            return
        if users.min() < 0 or users.max() >= self.cfg.n_users:
            raise IndexError(
                f"user ids out of range [0, {self.cfg.n_users})")
        items = np.asarray(items, np.int64).ravel()
        ts = np.asarray(ts, np.int64).ravel()
        k = self.cfg.buffer_len
        order = np.argsort(users, kind="stable")  # groups, arrival order
        us = users[order]
        starts = np.flatnonzero(np.r_[True, us[1:] != us[:-1]])
        sizes = np.diff(np.r_[starts, m])
        group = np.repeat(np.arange(len(starts)), sizes)
        j = np.arange(m) - starts[group]          # within-user sequence
        # events more than k from their user's batch end are overwritten
        # before they could ever be read — skip writing them
        keep = j >= (sizes[group] - k)
        slots = (self._count[us] + j) % k
        self._items[us[keep], slots[keep]] = items[order[keep]]
        self._ts[us[keep], slots[keep]] = ts[order[keep]]
        self._count[us[starts]] += sizes
        self.events_ingested += m

    def observe(self, ev) -> None:
        self.ingest(ev.user, ev.item, ev.ts)

    # ------------------------------------------------------------------
    def lookup(self, users: np.ndarray, now: int,
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Model-ready recent-history features visible at wall-time ``now``.

        Visibility: ts + ingest_latency <= now and ts >= now - retention.
        Returns (items, ts, valid) each (len(users), buffer_len) int32,
        right-aligned ascending time.
        """
        c = self.cfg
        users = np.asarray(users, np.int64).ravel()
        k = c.buffer_len
        pane_i = self._items[users]
        pane_t = self._ts[users]
        filled = np.arange(k)[None, :] < self._count[users][:, None]
        vis = filled & (pane_t >= now - c.retention) \
            & (pane_t <= now - c.ingest_latency)
        return sort_window_right_align(pane_i, pane_t, vis, k)
