"""Inference-time feature injection — the paper's contribution (§III-B).

"This approach merges user's batch-updated watch history and the recent
watch history, and then injects them as if it is batch-updated watch
history, while preserving the existing batch-trained model."

``FeatureInjector`` composes the two stores and the merge:

    features(users, now)
        batch  = BatchFeatureStore.lookup(users, now)      # stale, long
        recent = RealtimeFeatureService.lookup(users, now) # fresh, short
        return merge(batch, recent)                        # model-ready

The merge — time-order, dedup-by-item (freshest wins, real-time beats batch
on ties), truncate to feature_len — is the ``history_merge`` op
(kernels/history_merge): the CUDA kernel on the injector's device, or its
plain version when that device is the CPU.

Policies (selected per A/B arm):
  * "batch"   — control: batch features passed through untouched.
  * "inject"  — treatment: merged features injected as if batch.
  * "fresh"   — oracle upper bound / latency-ablation λ→0 limit: features
    recomputed from the full log at the request cutoff (no snapshot).
  * "decay"   — model-free recency baseline (Interest Clock, arXiv
    2404.19357): items scored by exponentially time-decayed event
    weights, ``0.5 ** (age / half_life)``, summed per item over the
    user's in-window events. The gateway serves these slates without
    the engine; ``features`` returns the same cutoff-exact features as
    "fresh" so :func:`decay_scores` sees every in-retention event.

The injector also anchors the serving path's cache-key invariant
(serving/scheduler.py): ``generation(now)`` names the snapshot cutoff whose
batch features are serving at ``now``, and everything derived from batch
features — including a user's cached prefill model state — is valid
exactly as long as that generation is. ``fresh_suffix(users, now)``
returns the complement: realtime events the serving snapshot *cannot*
contain (ts >= the generation's cutoff), which is precisely what may be
token-injected on top of a ``(user, generation)``-keyed cached state
without double-counting an event that the snapshot already absorbed.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.feature_store import BatchFeatureStore
from repro_torch.core.realtime import RealtimeFeatureService
from repro_torch.kernels.history_merge.ops import history_merge
from repro_torch.models.common import resolve_device

Features = Tuple[np.ndarray, np.ndarray, np.ndarray]  # items, ts, valid


def decay_scores(feats: Features, now: int, half_life: int,
                 n_items: int) -> np.ndarray:
    """Exponential time-decay item scores from event features.

    ``score[u, item] = sum over u's valid events of 0.5 ** (age /
    half_life)`` with ``age = now - ts`` — the Interest Clock recency
    weighting. Pure numpy on float64 with a fixed accumulation order,
    so identical inputs give bitwise-identical scores: the decay arm's
    slates are deterministic wherever its features are.
    """
    items, ts, valid = feats
    out = np.zeros((len(items), n_items), np.float64)
    r, c = np.nonzero(np.asarray(valid, bool))
    w = 0.5 ** ((now - ts[r, c].astype(np.float64)) / float(half_life))
    np.add.at(out, (r, items[r, c]), w)
    return out


@dataclasses.dataclass(frozen=True)
class InjectionConfig:
    policy: str = "inject"          # batch | inject | fresh | decay
    feature_len: int = 64           # output history length K
    # latency-ablation override: serve features as of (now - staleness)
    # computed directly from the log (policy "stale_cutoff").
    staleness: Optional[int] = None
    # "decay" policy: event half-life in request-clock units (default
    # one day — an event a day old carries half the weight of one now).
    half_life: int = 86400


class FeatureInjector:
    """The serving-path feature assembler for one A/B arm. The merge runs
    on ``device``."""

    def __init__(self, cfg: InjectionConfig, batch_store: BatchFeatureStore,
                 realtime: Optional[RealtimeFeatureService],
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.batch = batch_store
        self.realtime = realtime
        self.merge_calls = 0

    # ------------------------------------------------------------------
    def features(self, users: np.ndarray, now: int) -> Features:
        c = self.cfg
        if c.staleness is not None:
            # latency ablation: an idealized pipeline with refresh latency
            # `staleness` (0 = perfectly fresh).
            return self.batch.lookup_at_cutoff(users, now - c.staleness)
        if c.policy == "batch":
            return self.batch.lookup(users, now)
        if c.policy in ("fresh", "decay"):
            # decay shares the cutoff-exact feature path: its scoring
            # (decay_scores) wants every in-retention event, weighted by
            # age, with no snapshot staleness in the way.
            return self.batch.lookup_at_cutoff(users, now)
        if c.policy == "inject":
            b_items, b_ts, b_valid = self.batch.lookup(users, now)
            r_items, r_ts, r_valid = self.realtime.lookup(users, now)
            return self.merge((b_items, b_ts, b_valid),
                              (r_items, r_ts, r_valid))
        raise ValueError(f"unknown injection policy {c.policy!r}")

    # ------------------------------------------------------------------
    def generation(self, now: int) -> int:
        """Snapshot generation serving at ``now`` (-1 before the first
        snapshot). The serving gateway keys its prefill-state cache on this:
        a rolled generation changes the batch features, so every cached
        batch-history model state built from the old generation is stale."""
        snap = self.batch.latest_snapshot_ts(now)
        return -1 if snap is None else snap

    def fresh_suffix(self, users: np.ndarray, now: int,
                     ) -> List[List[Tuple[int, int]]]:
        """Per-user fresh-event suffixes for incremental (token-level)
        injection: realtime events visible at ``now`` that the serving
        snapshot cannot contain (ts >= snapshot cutoff), ascending time.

        Exact duplicate deliveries — same (item, ts) pair, the realtime
        service's at-least-once redelivery — are dropped; re-watches of an
        item at a *different* ts are kept (they are real events, and token
        injection, unlike the feature-level ``merge``, preserves repeats).
        """
        if self.realtime is None:
            return [[] for _ in range(len(users))]
        cutoff = self.generation(now)
        r_items, r_ts, r_valid = self.realtime.lookup(users, now)
        out: List[List[Tuple[int, int]]] = []
        for row in range(len(users)):
            seen = set()
            evs: List[Tuple[int, int]] = []
            for i, t, v in zip(r_items[row], r_ts[row], r_valid[row]):
                if not v or t < cutoff:
                    continue
                pair = (int(i), int(t))
                if pair in seen:
                    continue
                seen.add(pair)
                evs.append(pair)
            out.append(evs)
        return out

    def fresh_suffix_tokens(self, users: np.ndarray, now: int,
                            cap: Optional[int] = None,
                            ) -> List[List[int]]:
        """Per-user fresh suffixes as **model token** lists — what the
        serving path actually injects on top of a cached prefill state.

        Same visibility/dedup contract as :meth:`fresh_suffix`, with the
        item->token mapping (``core.pipeline.items_to_tokens``) applied
        and, when ``cap`` is given, each suffix truncated to its ``cap``
        *newest* events first — truncating before tokenization is what
        keeps the cached and full-prefill serving paths on identical
        token streams (the engine's ``pad_tokens`` would otherwise clip
        them at different lengths).
        """
        from repro_torch.core.pipeline import items_to_tokens
        out: List[List[int]] = []
        for evs in self.fresh_suffix(users, now):
            if cap is not None:
                evs = evs[-cap:]
            out.append(items_to_tokens(
                np.asarray([item for item, _ in evs], np.int64),
                np.ones(len(evs), np.int64)).tolist())
        return out

    # ------------------------------------------------------------------
    def merge(self, batch: Features, recent: Features) -> Features:
        """merge(batch, recent) -> injected features of length feature_len."""
        self.merge_calls += 1
        # int32 at the boundary, as the JAX package's merge sees its inputs
        args = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
            self.device) for a in (*batch, *recent)]
        out = history_merge(*args, out_len=self.cfg.feature_len)
        return tuple(t.cpu().numpy() for t in out)
