"""Loop-based reference feature plane: the JAX package's
``core/_reference.py``, copied bit for bit.

The original per-user Python-list/deque implementations of the batch
feature store and the realtime feature service, kept as a
differential-testing oracle for the port's array-backed stores
(``tests/test_torch_feature_plane_diff.py``). They are NOT on any serving
path: ``feature_store.py`` and ``realtime.py`` are.
"""
from __future__ import annotations

import bisect
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.feature_store import FeatureStoreConfig
from repro_torch.core.realtime import RealtimeConfig


class ReferenceBatchFeatureStore:
    """Per-user event lists + per-user snapshot loops (seed semantics)."""

    def __init__(self, cfg: FeatureStoreConfig):
        self.cfg = cfg
        self._log: List[List[Tuple[int, int]]] = [[] for _ in range(cfg.n_users)]
        self._snapshots: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        self._snapshot_times: List[int] = []

    def append(self, user: int, item: int, ts: int) -> None:
        self._log[user].append((ts, item))

    def append_events(self, events) -> None:
        for ev in events:
            self.append(ev.user, ev.item, ev.ts)

    def run_snapshot(self, snapshot_ts: int) -> None:
        c = self.cfg
        k = c.feature_len
        items = np.zeros((c.n_users, k), np.int32)
        ts_arr = np.zeros((c.n_users, k), np.int32)
        valid = np.zeros((c.n_users, k), np.int32)
        lo = snapshot_ts - c.window
        for u in range(c.n_users):
            evs = [e for e in self._log[u] if lo <= e[0] < snapshot_ts]
            evs.sort()
            evs = evs[-k:]
            n = len(evs)
            if n:
                items[u, k - n:] = [e[1] for e in evs]
                ts_arr[u, k - n:] = [e[0] for e in evs]
                valid[u, k - n:] = 1
        self._snapshots[snapshot_ts] = (items, ts_arr, valid)
        bisect.insort(self._snapshot_times, snapshot_ts)

    def latest_snapshot_ts(self, now: int) -> Optional[int]:
        i = bisect.bisect_right(self._snapshot_times, now) - 1
        return self._snapshot_times[i] if i >= 0 else None

    def lookup(self, users: np.ndarray, now: int,
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        snap = self.latest_snapshot_ts(now)
        k = self.cfg.feature_len
        if snap is None:
            z = np.zeros((len(users), k), np.int32)
            return z, z.copy(), z.copy()
        items, ts_arr, valid = self._snapshots[snap]
        return items[users], ts_arr[users], valid[users]

    def lookup_at_cutoff(self, users: np.ndarray, cutoff: int,
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        c = self.cfg
        k = c.feature_len
        items = np.zeros((len(users), k), np.int32)
        ts_arr = np.zeros((len(users), k), np.int32)
        valid = np.zeros((len(users), k), np.int32)
        lo = cutoff - c.window
        for j, u in enumerate(users):
            evs = [e for e in self._log[u] if lo <= e[0] < cutoff]
            evs.sort()
            evs = evs[-k:]
            n = len(evs)
            if n:
                items[j, k - n:] = [e[1] for e in evs]
                ts_arr[j, k - n:] = [e[0] for e in evs]
                valid[j, k - n:] = 1
        return items, ts_arr, valid

    def user_events(self, user: int) -> List[Tuple[int, int]]:
        return sorted(self._log[user])


class ReferenceRealtimeFeatureService:
    """Per-user deques over the simulated event stream (seed semantics)."""

    def __init__(self, cfg: RealtimeConfig):
        self.cfg = cfg
        self._buf: List[Deque[Tuple[int, int]]] = [
            deque(maxlen=cfg.buffer_len) for _ in range(cfg.n_users)]
        self.events_ingested = 0

    def ingest(self, user: int, item: int, ts: int) -> None:
        self._buf[user].append((ts, item))
        self.events_ingested += 1

    def observe(self, ev) -> None:
        self.ingest(ev.user, ev.item, ev.ts)

    def lookup(self, users: np.ndarray, now: int,
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        c = self.cfg
        k = c.buffer_len
        items = np.zeros((len(users), k), np.int32)
        ts_arr = np.zeros((len(users), k), np.int32)
        valid = np.zeros((len(users), k), np.int32)
        hi = now - c.ingest_latency
        lo = now - c.retention
        for j, u in enumerate(users):
            evs = [e for e in self._buf[u] if lo <= e[0] <= hi]
            evs.sort()
            evs = evs[-k:]
            n = len(evs)
            if n:
                items[j, k - n:] = [e[1] for e in evs]
                ts_arr[j, k - n:] = [e[0] for e in evs]
                valid[j, k - n:] = 1
        return items, ts_arr, valid
