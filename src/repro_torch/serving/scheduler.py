"""Request-level serving: the Gateway facade + micro-batching scheduler.

The engine serves one fixed ``max_batch`` pane shape per entry point, but
real traffic is per-request: arrivals trickle in, carry their own A/B
arm (policy) and slate length, and are not pre-grouped into waves. The
:class:`Gateway` is the bridge — the *one* serving facade:

    ticket = gw.submit(Request(user=7, now=now))    # enqueue an arrival
    gw.observe(Event(user=7, item=42, ts=now))      # feedback ingestion
    gw.tick(now + 60)                               # clock: snapshots,
                                                    # deadline flushes
    ticket.response.slate                           # filled at flush

**Micro-batching.** Queued requests coalesce into the engine's
fixed-shape ``max_batch`` panes. A pane flushes when it is *full*, or
when a queued request's ``deadline`` is reached by the gateway clock
(the pane is padded and served short — latency beats utilization once a
deadline fires), or on an explicit ``flush()``. When more than one
pane's worth of requests is queued at drain time, the scheduler reuses
the cache-aware partitioning the wave path proved out: rows whose
``(user, generation)`` prefill state is cached are grouped into
pure-hit panes ahead of miss rows (stable order otherwise), so one cold
row cannot drag a pane of hits onto the prefill path. Rows are
independent, so regrouping never changes any row's result.

**Continuous batching** (``ServerConfig.max_wait``). Wave semantics
make a trickle arrival wait for its pane to fill (or for a deadline):
at one arrival per sim-second and ``max_batch=16`` the last-served row
has waited 15 seconds before the pane even forms. With ``max_wait``
set, a queued request is served once it has waited that long —
``max_wait=0`` admits every arrival immediately in a padded partial
pane — while a backlogged queue (``submit_many``, or arrivals faster
than service) still forms full panes first, so the scheduler degrades
to wave behavior exactly when utilization matters. Rows are
independent, so any grouping serves bitwise-identical results; the
knob only trades pane occupancy against queue delay. Completed tickets
stream out through :meth:`Gateway.poll` / :meth:`Gateway.drain` as
their rows retire — callers are no longer forced through wave-shaped
``flush()``.

**The host prefill-state LRU and the paged state pool.** By default
per-user prefill states live in a host LRU of CPU tensors
(:class:`PrefillStateCache`): a miss pane's prefill state is copied to
the host once per cache leaf and sliced into per-row entries, and every
pane is re-assembled with host concats and one host->device copy per
leaf. With ``ServerConfig.pool_slots`` set, states live in a
preallocated slot pool on the engine's device (serving/pool.py): pane
assembly is an indexed gather and admission writeback an indexed
scatter, and no state visits the host. The slot table
(:class:`PagedStateCache`) keeps the host LRU's exact key/counter/rekey
surface, so the warm handoff composes unchanged — a generation rekey
renames table keys and never touches device tensors. Both backends
serve bitwise-identical slates (tests/test_torch_state_pool.py).

**Online weight patches.** ``install_patch`` hot-swaps an
:class:`~repro_torch.training.online.WeightPatch` between panes: the
engine copies the new leaf values into its own tensors (its captured
slate graphs stay valid), and the cache generation's model-version axis
advances, so no state prefilled under the old weights is served again.
``attach_trainer`` makes an :class:`~repro_torch.training.OnlineTrainer`
the patch source, drained at every ``tick`` and drain.

**Mixed-policy panes.** Per-request ``policy`` resolves at
feature-assembly time, so control ("batch"), treatment ("inject") and
oracle ("fresh") rows coexist in one pane: batch/inject rows share the
snapshot history (and therefore the same cached prefill state — a batch
row is just an inject row with an empty suffix), while fresh rows are
prefilled at the request cutoff as *ephemeral* admissions (never
cached: their history depends on ``now``, violating the cache-key
invariant). This is what makes the paper's A/B split expressible on one
serving fleet: arms are request labels, not server deployments.

**Generation rollover.** The daily boundary is no longer a cliff: with
``ServerConfig.snapshot_build_budget`` set, the snapshot build runs as
an incremental :class:`~repro_torch.core.feature_store.SnapshotBuilder`
advanced one budget-bounded slice per clock call (serving keeps
reading the previous generation until the build lands), and when the
generation does roll, the cache takes a **warm handoff**: entries
whose snapshot row is bitwise unchanged are rekeyed to the new
generation (identical history => identical prefill state — results
are bitwise what a purge + re-prefill would serve), changed users are
invalidated and optionally re-warmed between panes by a budgeted
``warm_step``. See docs/serving.md "Generation rollover".

**Telemetry.** Every response carries a :class:`RequestTelemetry`
(pane id, queue delay, cache hit, prefill-vs-inject path, generation);
``Gateway.stats()`` aggregates them (path counts, queue-delay
percentiles over a sliding window, rollover rekey/invalidate/build
counters) on top of the engine/cache counters.

The legacy wave API (``InjectionServer.serve(users, now)`` in
serving/loop.py) is a thin wrapper over this facade and serves
bitwise-identical results: a wave is ``submit_many`` + ``flush`` with
every request on the gateway defaults.
"""
from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.injection import FeatureInjector, decay_scores
from repro_torch.core.pipeline import items_to_tokens
from repro_torch.serving.api import (POLICIES, GatewayStats, Request,
                                     RequestTelemetry, Response,
                                     RolloverStats, Ticket, as_event)
from repro_torch.serving.engine import ServingEngine, _leaves, _tree_map
from repro_torch.serving.pool import DeviceStatePool, PagedStateCache


# ----------------------------------------------------------------------
# Prefill-state cache
# ----------------------------------------------------------------------

class PrefillStateCache:
    """LRU cache: (user, generation) -> one user's prefill state.

    An entry holds the sequence-form engine state sliced to one row
    (cache leaves keep their leading layer-repeat axis; batch axis 1 has
    extent 1) plus the prefill's last-position logits — the next-item
    scores when the request carries no fresh suffix.

    Eviction runs over two budgets: an entry count (``budget``) and an
    optional **per-shard byte** budget (``byte_budget``). Byte accounting
    is per data-parallel shard because that is the unit that must fit in
    one device's memory: a single-row entry is replicated host-side, but the
    moment rows are assembled into a pane and shipped to a ``dp``-way
    mesh, each shard holds ``1/dp`` of the pane — so an entry's
    accountable size is ``ceil(nbytes / shards)``. ``shards`` is the
    engine's data-axis size (1 on a single device, making per-shard ==
    total).
    """

    def __init__(self, budget: int, byte_budget: Optional[int] = None,
                 shards: int = 1):
        if budget < 1:
            raise ValueError(f"cache budget must be >= 1, got {budget}")
        if byte_budget is not None and byte_budget < 1:
            raise ValueError(
                f"byte budget must be >= 1 when set, got {byte_budget}")
        self.budget = budget
        self.byte_budget = byte_budget
        self.shards = max(int(shards), 1)
        # value = (entry, per-shard bytes); bytes memoized at put() time so
        # eviction/statistics never re-walk the state pytree
        self._entries: "OrderedDict[Tuple[int, int], Tuple[Dict[str, Any], int]]" = \
            OrderedDict()
        self.bytes_per_shard = 0      # current resident total, per shard
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        self.rekeys = 0
        # handoff window: old-generation entries of CHANGED users kept
        # alive across a rollover (retain_changed rekey). They are the
        # first victims under any budget pressure — dual-generation
        # residency is a courtesy, never worth evicting a live entry for.
        self._handoff_stale: set = set()
        self.stale_evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Tuple[int, int]) -> bool:
        return key in self._entries

    @staticmethod
    def entry_nbytes(entry: Dict[str, Any]) -> int:
        """Logical bytes of one cached state (every leaf with ``nbytes``:
        tensors, and numpy arrays as the reference counts them)."""
        return sum(x.nbytes for x in _leaves(entry) if hasattr(x, "nbytes"))

    def get(self, user: int, gen: int) -> Optional[Dict[str, Any]]:
        rec = self._entries.get((user, gen))
        if rec is None:
            self.misses += 1
            return None
        self._entries.move_to_end((user, gen))
        self.hits += 1
        return rec[0]

    def _pop_lru(self) -> None:
        # rollover-aware victim order: a retained dual-generation entry
        # (changed user, old generation — kept through the handoff
        # window) evicts before ANY live entry, in LRU order among the
        # stale; only when no stale entry remains does the true LRU go.
        # The scan is bounded by the handoff window: _handoff_stale is
        # empty outside it, so steady-state eviction stays O(1).
        if self._handoff_stale:
            key = next((k for k in self._entries
                        if k in self._handoff_stale), None)
            if key is not None:
                nb = self._entries.pop(key)[1]
                self._handoff_stale.discard(key)
                self.bytes_per_shard -= nb
                self.evictions += 1
                self.stale_evictions += 1
                return
            self._handoff_stale.clear()  # all dangling: drop the set
        _, (_, nb) = self._entries.popitem(last=False)
        self.bytes_per_shard -= nb
        self.evictions += 1

    def put(self, user: int, gen: int, entry: Dict[str, Any]) -> None:
        nb = -(-self.entry_nbytes(entry) // self.shards)  # ceil div
        old = self._entries.get((user, gen))
        if old is not None:
            self.bytes_per_shard -= old[1]
        self._entries[(user, gen)] = (entry, nb)
        self._entries.move_to_end((user, gen))
        self.bytes_per_shard += nb
        while len(self._entries) > self.budget:
            self._pop_lru()
        while (self.byte_budget is not None and len(self._entries) > 1
               and self.bytes_per_shard > self.byte_budget):
            # len > 1: the just-admitted entry always stays — a byte budget
            # smaller than one entry must still serve the current pane
            self._pop_lru()

    def invalidate_except(self, gen: int) -> int:
        """Purge every entry from a generation other than ``gen``."""
        stale = [k for k in self._entries if k[1] != gen]
        for k in stale:
            self.bytes_per_shard -= self._entries.pop(k)[1]
        self.invalidations += len(stale)
        self._handoff_stale = {k for k in self._handoff_stale
                               if k in self._entries}
        return len(stale)

    def rekey_generation(self, old_gen: int, new_gen: int, changed,
                         retain_changed: bool = False) -> Tuple[int, int]:
        """Warm handoff across a generation rollover.

        Entries keyed ``(user, old_gen)`` whose user is **not** in
        ``changed`` are rekeyed to ``(user, new_gen)`` in place (LRU
        order and byte accounting preserved): an unchanged snapshot row
        means an identical batch history, and a prefill state is a pure
        function of (history, params) — so the entry under the new key
        is bitwise the entry a fresh admission would build. The caller is
        responsible for ``changed`` being a certified row-diff between
        two frozen generations
        (``BatchFeatureStore.changed_users_between``); rekeying across a
        recomputed (evicted) generation is never safe.

        Changed users' ``old_gen`` entries are invalidated — or, with
        ``retain_changed=True``, retained under their old key for the
        handoff window (the cache briefly holds both generations for
        those users) and marked first-victim for every budget eviction;
        the next handoff or ``invalidate_except`` sweeps survivors.
        Entries from any other stale generation, and ``old_gen``
        duplicates of users already cached under ``new_gen``, are always
        invalidated.

        Returns ``(rekeyed, invalidated)`` counts; the retained set is
        ``_handoff_stale`` / ``stats()["handoff_stale"]``.
        """
        changed_set = {int(u) for u in np.asarray(changed).ravel()}
        live_new = {u for (u, g) in self._entries if g == new_gen}
        out: "OrderedDict[Tuple[int, int], Tuple[Dict[str, Any], int]]" = \
            OrderedDict()
        stale: set = set()
        rekeyed = invalidated = 0
        for (u, g), rec in self._entries.items():
            if g == new_gen:
                out[(u, g)] = rec
            elif g == old_gen and u not in live_new:
                if u not in changed_set:
                    out[(u, new_gen)] = rec
                    rekeyed += 1
                elif retain_changed:
                    out[(u, g)] = rec
                    stale.add((u, g))
                else:
                    self.bytes_per_shard -= rec[1]
                    invalidated += 1
            else:
                self.bytes_per_shard -= rec[1]
                invalidated += 1
        self._entries = out
        self._handoff_stale = stale
        self.rekeys += rekeyed
        self.invalidations += invalidated
        return rekeyed, invalidated

    def rekey_entry(self, user: int, old_gen, new_gen) -> bool:
        """Rename ONE entry ``(user, old_gen)`` -> ``(user, new_gen)``
        in place (the per-entry twin of :meth:`rekey_generation`, used
        by the O(delta) re-warm: the caller has certified that the old
        entry plus a deferred inject reproduces what a fresh admission
        at ``new_gen`` would serve). Counts as a rekey; an existing
        ``new_gen`` entry for the user is replaced. Returns False when
        no ``(user, old_gen)`` entry exists."""
        rec = self._entries.pop((user, old_gen), None)
        if rec is None:
            return False
        prev = self._entries.pop((user, new_gen), None)
        if prev is not None:
            self.bytes_per_shard -= prev[1]
        self._entries[(user, new_gen)] = rec
        self._entries.move_to_end((user, new_gen))
        self._handoff_stale.discard((user, old_gen))
        self.rekeys += 1
        return True

    def drop(self, user: int, gen) -> bool:
        """Invalidate one entry (serve-time fallback when a deferred
        delta no longer fits the inject budget: the row must take a
        full prefill instead). Returns False when absent."""
        rec = self._entries.pop((user, gen), None)
        if rec is None:
            return False
        self.bytes_per_shard -= rec[1]
        self._handoff_stale.discard((user, gen))
        self.invalidations += 1
        return True

    # ------------------------------------------------------------------
    # Backend-neutral delta-rewarm surface (mirrored by PagedStateCache:
    # here pending tokens live inside the host entry dict, there in a
    # host-side sidecar next to the slot table — the gateway only ever
    # talks to these three methods)
    # ------------------------------------------------------------------

    def has_entry(self, user: int, gen) -> bool:
        """Membership probe with NO side effects — no LRU bump, no
        hit/miss counters (``get`` counts; this peeks)."""
        return (user, gen) in self._entries

    def get_pending(self, user: int, gen) -> Optional[list]:
        """The entry's deferred-inject token list, or None."""
        rec = self._entries.get((user, gen))
        return rec[0].get("pending") if rec is not None else None

    def set_pending(self, user: int, gen, tokens) -> None:
        """Attach (or, with an empty list, clear) the entry's deferred
        snapshot-delta tokens. Raises KeyError when the entry is absent
        — pending tokens without a state to defer onto are a bug."""
        rec = self._entries.get((user, gen))
        if rec is None:
            raise KeyError(f"no entry ({user}, {gen}) to attach pending "
                           f"inject tokens to")
        if tokens:
            rec[0]["pending"] = list(tokens)
        else:
            rec[0].pop("pending", None)

    def stats(self) -> Dict[str, int]:
        return {"entries": len(self._entries), "hits": self.hits,
                "misses": self.misses, "evictions": self.evictions,
                "invalidations": self.invalidations,
                "rekeys": self.rekeys,
                "handoff_stale": len(self._handoff_stale),
                "stale_evictions": self.stale_evictions,
                "bytes_per_shard": self.bytes_per_shard,
                "shards": self.shards}


# ----------------------------------------------------------------------
# Config
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Gateway/serving configuration, validated at construction.

    ``slate_len`` is the *default* items-per-request (a Request may
    override it per row, up to the engine's vocabulary — checked at
    Gateway construction / submit, where the engine is known).
    ``cache_entries`` is the prefill-state LRU budget; ``warm()`` clamps
    its user list to it (warming past the budget would prefill states
    that evict before they ever serve), so a budget of 1 is legal but
    warms exactly one user.

    **Rollover behavior.** ``warm_handoff`` keeps the rollover warm:
    cached prefill states whose snapshot row is unchanged across the
    generation roll are rekeyed to the new generation instead of purged
    (results are bitwise identical either way — the handoff only changes
    which rows pay a prefill). ``snapshot_build_budget`` switches the
    daily job from one synchronous full materialization inside
    ``submit``/``tick`` to an incremental delta build advanced by at
    most that many users per clock call (``None`` keeps the legacy
    synchronous build). ``background_build`` moves the whole build onto
    a dedicated worker thread (``BackgroundSnapshotBuilder``): clock
    calls shrink to O(1) ``poll()``s and the finished generation
    installs atomically on the serving thread — bitwise the same arrays
    as the synchronous modes, at the memory cost of double-buffering
    the feature plane during the build (it supersedes
    ``snapshot_build_budget``; sync stays the default).
    ``rewarm_budget`` re-prefills up to that many
    invalidated (changed) users per ``tick`` after a rollover, so the
    miss storm drains between panes instead of on live requests (0 =
    off; ``warm_step()`` can also be driven explicitly).

    **Continuous batching / the paged pool.** ``max_wait`` bounds how
    long a queued request may wait (in request-clock units) before it
    is served in a padded partial pane — ``0`` serves every arrival the
    moment it lands, ``None`` keeps wave semantics (pane-full /
    deadline / explicit flush only). ``pool_slots`` moves the
    prefill-state cache from the host LRU to a device-resident slot
    pool (serving/pool.py; must be >= the engine's ``max_batch``, and
    it supersedes ``cache_entries``/``cache_bytes`` — a fixed pool IS
    both budgets).

    **Deadline-aware load shedding.** ``pane_service_time`` gives the
    scheduler a service model: executing one pane occupies the server
    for that many request-clock units, tracked by a busy-until marker
    (``None`` keeps the legacy instantaneous-service semantics — served
    results are bitwise unchanged either way; the model only adds
    completion-time accounting). On top of it, ``shed_policy="deadline"``
    rejects a request — at submit time or when its pane would form —
    whenever its *projected* completion time (queue position ahead of
    it, in panes, times the pane cost, on top of the busy-until marker)
    exceeds its deadline: a slate served after its deadline is worthless
    to the caller, and executing it anyway steals service time from
    requests that can still make theirs. A shed request's ticket
    resolves immediately with a typed ``Response(shed=True)`` marker
    (empty slate, telemetry ``path="shed"``) and is counted in
    ``GatewayStats.shed``; requests without a deadline are never shed.
    Requests that ARE served past their deadline (a coarse tick jumped
    the clock past it, or the service model's pane cost overran it)
    count in ``GatewayStats.deadline_misses``.
    """
    slate_len: int = 4            # items decoded per request (default)
    cache_entries: int = 4096     # LRU budget (user-generation states)
    cache_bytes: Optional[int] = None  # per-shard byte budget (None = off)
    use_cache: bool = True        # False -> full prefill per request
    run_batch_jobs: bool = True   # roll due snapshots on the clock
    warm_handoff: bool = True     # rekey unchanged rows across rollover
    snapshot_build_budget: Optional[int] = None  # users per build step
    background_build: bool = False  # build snapshots on a worker thread
    rewarm_budget: int = 0        # users re-prefilled per tick post-roll
    pool_slots: Optional[int] = None  # device state-pool slots (None = host LRU)
    max_wait: Optional[int] = None    # serve a request after waiting this long
    pane_service_time: Optional[int] = None  # sim-s one pane occupies the server
    shed_policy: Optional[str] = None  # None | "deadline" (needs service time)
    patch_policy: str = "purge"   # "purge" | "rewarm": cache policy at a
    #                               weight-patch install (see install_patch)
    delta_rewarm: bool = False    # O(delta) re-warm via deferred inject
    #                               (see _try_delta_rewarm)
    log_compaction: Optional[str] = None  # None | "sync" | "background":
    #                               tick-driven tiered-EventLog window
    #                               compaction (needs a windowed log)

    def __post_init__(self):
        if self.snapshot_build_budget is not None \
                and self.snapshot_build_budget < 1:
            raise ValueError(
                f"snapshot_build_budget must be >= 1 when set (None runs "
                f"the legacy synchronous build), got "
                f"{self.snapshot_build_budget}")
        if self.rewarm_budget < 0:
            raise ValueError(
                f"rewarm_budget must be >= 0, got {self.rewarm_budget}")
        if self.slate_len < 1:
            raise ValueError(
                f"slate_len must be >= 1, got {self.slate_len}")
        if self.cache_entries < 1:
            raise ValueError(
                f"cache_entries must be >= 1, got {self.cache_entries} "
                f"(warm() clamps its user list to this budget, so even a "
                f"cacheless deployment needs a >= 1 placeholder — use "
                f"use_cache=False to disable caching)")
        if self.cache_bytes is not None and self.cache_bytes < 1:
            raise ValueError(
                f"cache_bytes must be >= 1 when set (None disables the "
                f"byte budget), got {self.cache_bytes}")
        if self.pool_slots is not None and self.pool_slots < 1:
            raise ValueError(
                f"pool_slots must be >= 1 when set (None keeps the host "
                f"LRU), got {self.pool_slots}")
        if self.max_wait is not None and self.max_wait < 0:
            raise ValueError(
                f"max_wait must be >= 0 when set (0 serves every arrival "
                f"immediately; None keeps wave semantics), got "
                f"{self.max_wait}")
        if self.pane_service_time is not None and self.pane_service_time < 1:
            raise ValueError(
                f"pane_service_time must be >= 1 when set (None keeps "
                f"instantaneous-service semantics), got "
                f"{self.pane_service_time}")
        if self.shed_policy not in (None, "deadline"):
            raise ValueError(
                f"unknown shed_policy {self.shed_policy!r}; expected "
                f"None (never shed) or 'deadline'")
        if self.shed_policy is not None and self.pane_service_time is None:
            raise ValueError(
                "shed_policy='deadline' needs pane_service_time set: "
                "without a service model every queue drains instantly "
                "and no projected completion can ever miss a deadline")
        if self.patch_policy not in ("purge", "rewarm"):
            raise ValueError(
                f"unknown patch_policy {self.patch_policy!r}; expected "
                f"'purge' (drop version-stale entries at a weight-patch "
                f"install) or 'rewarm' (queue them for budgeted re-warm)")
        if self.log_compaction not in (None, "sync", "background"):
            raise ValueError(
                f"unknown log_compaction {self.log_compaction!r}; "
                f"expected None (no tick-driven compaction), 'sync' "
                f"(compact inline on the tick that finds a window due) "
                f"or 'background' (off-thread BackgroundCompactor, "
                f"polled/installed on ticks)")


# ----------------------------------------------------------------------
# The Gateway
# ----------------------------------------------------------------------

class Gateway:
    """The unified serving facade: request submission, micro-batching,
    event ingestion and clock/snapshot management in one object.

    The engine owns all placement: the gateway only ever builds
    fixed-shape ``max_batch`` panes and hands them to the engine's
    device, so the scheduling code has no device branches at all.

    On a device mesh every rank runs the same Gateway (same seed, same
    operations, in the same order: SPMD), so a hit on one rank is a hit on
    every rank and every rank issues the same collectives. The host LRU
    holds every row on every rank (each row's model dims are the rank's
    shards), and its bytes are counted as one device would hold them
    (``ServingEngine.logical_nbytes``) and divided by the data shards,
    ``ceil(nbytes / shards)``, as the JAX package counts its data-sharded
    panes; so every non-wall-clock ``stats()`` counter is the JAX
    Gateway's on the same mesh.
    """

    def __init__(self, engine: ServingEngine, injector: FeatureInjector,
                 cfg: ServerConfig = ServerConfig()):
        if injector.cfg.policy not in POLICIES:
            raise ValueError(
                f"unknown default policy {injector.cfg.policy!r} on the "
                f"injector; the gateway serves {POLICIES}")
        if cfg.slate_len > engine.cfg.vocab_size:
            raise ValueError(
                f"slate_len={cfg.slate_len} exceeds the engine's item "
                f"vocabulary ({engine.cfg.vocab_size}); a slate decodes "
                f"distinct items, so it cannot be longer than the catalog")
        self.engine = engine
        self.injector = injector
        self.cfg = cfg
        if cfg.pool_slots is not None:
            self.pool: Optional[DeviceStatePool] = DeviceStatePool(
                engine, cfg.pool_slots)
            self.cache = PagedStateCache(self.pool)
        else:
            self.pool = None
            self.cache = PrefillStateCache(cfg.cache_entries,
                                           byte_budget=cfg.cache_bytes,
                                           shards=engine.data_shards)
            if engine.mesh is not None:
                self.cache.entry_nbytes = engine.logical_nbytes
        # the cache-key generation is COMPOSITE: (snapshot cutoff,
        # model version). Both caches compare keys only by equality, so
        # a weight-patch install invalidates exactly like a snapshot
        # roll — by making every old key unequal to the current one
        self._gen: Optional[Tuple[int, int]] = None
        self._model_version = 0   # advances only inside install_patch
        self._trainer = None      # attached OnlineTrainer (patch source)
        # (old_vgen, new_vgen) of the last CERTIFIED warm handoff, while
        # its retained old-generation entries are still eligible for the
        # O(delta) deferred-inject re-warm; cleared by the next handoff
        # or patch install
        self._handoff_from: Optional[Tuple[Tuple[int, int],
                                           Tuple[int, int]]] = None
        self._clock: Optional[int] = None
        self._queue: List[Ticket] = []
        self._completed: deque = deque()  # served, unclaimed by poll()
        self._next_id = 0
        # incremental daily job (snapshot_build_budget mode)
        self._builder = None          # in-flight SnapshotBuilder, or None
        self._compactor = None        # BackgroundCompactor, lazily created
        self._skip_register: List[int] = []  # past-retention boundaries,
        #                               registered when the build installs
        self._rewarm_queue: deque = deque()  # users invalidated at handoff
        # counters / telemetry
        self.requests = 0
        self.panes = 0
        self.prefill_calls = 0
        self.inject_calls = 0
        self.decode_steps = 0
        self.shed = 0             # requests rejected by the load-shedder
        self.deadline_misses = 0  # requests served past their deadline
        self._busy_until = 0      # service model: sim-time the server frees
        self._path_counts = {"prefill": 0, "inject": 0, "cached": 0,
                             "decay": 0}
        self._queue_delays: deque = deque(maxlen=4096)
        self._deadline_flushes = 0
        self._rollover = {"rollovers": 0, "rekeyed": 0, "invalidated": 0,
                          "retained": 0, "rebuilt": 0, "delta_rewarms": 0,
                          "build_steps": 0, "build_time_s": 0.0,
                          "build_slice_max_s": 0.0}
        self._patches_applied = 0
        self._patch_install_max_s = 0.0

    # ------------------------------------------------------------------
    # Clock / snapshot plumbing
    # ------------------------------------------------------------------

    @property
    def clock(self) -> Optional[int]:
        """The gateway's current time: the max ``now`` seen across
        submit/tick/flush. Never moves backwards."""
        return self._clock

    @property
    def pending(self) -> int:
        """Requests queued but not yet served."""
        return len(self._queue)

    def _advance(self, now: Optional[int]) -> None:
        if now is not None and (self._clock is None or now > self._clock):
            self._clock = int(now)

    def _sync_generation(self, now: int) -> Tuple[int, int]:
        """Advance the daily job and hand the cache across any resulting
        generation roll. Returns the current **composite** generation
        ``(snapshot cutoff, model version)`` — the cache key axis pair:
        snapshot rolls move the first component (warm handoff below),
        weight-patch installs move the second (``install_patch``).

        With ``snapshot_build_budget`` unset the job is the legacy
        synchronous ``maybe_run_due_snapshots`` (a due boundary
        materializes the full plane inside this call); with a budget the
        in-flight :class:`SnapshotBuilder` advances by at most one
        budget-sized slice per call, so a 1M-user build amortizes across
        panes instead of stalling one submit; with ``background_build``
        the slice is an O(1) ``poll()`` of the worker thread. Either
        way, the moment the generation actually rolls the cache takes
        the **warm handoff** (see ``_handoff``) instead of the old
        purge-everything. The wall time each call spends advancing the
        job is tracked in ``build_slice_max_s`` — the boundary-stall
        telemetry the scenario SLO gates read."""
        if self.cfg.run_batch_jobs:
            t0 = time.perf_counter()
            if self.cfg.background_build \
                    or self.cfg.snapshot_build_budget is not None:
                self._step_snapshot_build(now)
            else:
                self.injector.batch.maybe_run_due_snapshots(now)
            dt = time.perf_counter() - t0
            if dt > self._rollover["build_slice_max_s"]:
                self._rollover["build_slice_max_s"] = dt
        gen = (self.injector.generation(now), self._model_version)
        if gen != self._gen:
            self._handoff(self._gen, gen)
            self._gen = gen
        return gen

    def _step_snapshot_build(self, now: int) -> None:
        """One budget-bounded slice of the amortized daily job: start a
        builder when a boundary has passed, advance it.

        Catch-up matches the synchronous job's contract: after a gap of
        several periods, every missed boundary inside the retention
        window is built **in order** (one builder each — which also
        keeps every delta one-period small), and only boundaries that
        would be evicted immediately register without arrays. The
        generation therefore rolls forward boundary by boundary as
        builds land, never jumping over a generation the synchronous
        path would have materialized."""
        store = self.injector.batch
        c = store.cfg
        latest_due = store.latest_due_boundary(now)
        if self._builder is None:
            if not store._snapshot_times:
                # cold store: there is no previous generation to delta
                # against or serve from, so amortizing buys nothing —
                # delegate the whole catch-up to the synchronous job
                store.maybe_run_due_snapshots(now)
                return
            due = store._snapshot_times[-1] + c.snapshot_period
            if due > latest_due:
                return
            # boundaries already past retention will register WITHOUT
            # arrays (the synchronous job's retention skip) — but only
            # once the first real build installs: registering them now
            # would make a register-only generation the serving latest
            # for the whole build window, and everything cached against
            # it would key to a recompute-on-read (non-frozen)
            # generation, violating the cache-key invariant
            skipped = []
            while c.snapshot_retention is not None and due <= latest_due \
                    - c.snapshot_retention * c.snapshot_period:
                skipped.append(due)
                due += c.snapshot_period
            self._builder = (store.begin_snapshot_background(due)
                             if self.cfg.background_build
                             else store.begin_snapshot(due))
            self._skip_register = skipped
        b = self._builder
        if self.cfg.background_build:
            # O(1) while the worker runs; the call that finds the worker
            # finished pays only the finish-time fixup + atomic install
            remaining = b.poll()
        else:
            remaining = b.step(self.cfg.snapshot_build_budget)
            self._rollover["build_steps"] += 1
        if remaining == 0:
            if self.cfg.background_build:
                self._rollover["build_steps"] += b.steps
            self._rollover["build_time_s"] += b.step_time_s
            for due in self._skip_register:
                store._register_time(due)
            self._skip_register = []
            self._builder = None

    def _handoff(self, old_gen: Optional[Tuple[int, int]],
                 new_gen: Tuple[int, int]) -> None:
        """Cache handoff at a generation roll: rekey entries whose
        snapshot row is unchanged (identical history => identical prefill
        state, so served results are bitwise what a purge + re-prefill
        would produce), invalidate the changed rest, and queue the
        invalidated users for budgeted re-warming. Falls back to the
        purge-everything rollover whenever the exact changed set cannot
        be certified (first generation, handoff disabled, a generation
        gap, either generation evicted/recomputed, or a model-version
        change riding the same roll — a prefill state is a function of
        (history, params), so rekeying across params is never safe;
        ``install_patch`` handles the params axis itself)."""
        self._handoff_from = None
        if old_gen is None:
            # first sync: the gateway is discovering the current
            # generation, not rolling one — nothing can be cached yet
            self.cache.invalidate_except(new_gen)
            return
        changed = None
        if self.cfg.warm_handoff and old_gen[0] >= 0 \
                and old_gen[1] == new_gen[1]:
            changed = self.injector.batch.changed_users_between(
                old_gen[0], new_gen[0])
        stale_users = [u for (u, g) in self.cache._entries if g != new_gen]
        if changed is None:
            invalidated = self.cache.invalidate_except(new_gen)
            rekeyed = 0
        else:
            # certified handoff: changed users' old-generation entries
            # are RETAINED for the handoff window (first-victim under
            # budget pressure) instead of purged — the dual-generation
            # residency the rollover-aware eviction order manages
            rekeyed, invalidated = self.cache.rekey_generation(
                old_gen, new_gen, changed, retain_changed=True)
            self._rollover["retained"] += len(self.cache._handoff_stale)
            self._handoff_from = (old_gen, new_gen)
        # MRU-first re-warm order: the hottest invalidated users are the
        # ones most likely to be requested right after the roll
        # (dict.fromkeys dedups a user cached under two stale generations)
        self._rewarm_queue = deque(dict.fromkeys(
            u for u in reversed(stale_users)
            if (u, new_gen) not in self.cache))
        self._rollover["rollovers"] += 1
        self._rollover["rekeyed"] += rekeyed
        self._rollover["invalidated"] += invalidated

    # ------------------------------------------------------------------
    # Online weight patches (hot swap)
    # ------------------------------------------------------------------

    def attach_trainer(self, trainer) -> None:
        """Attach an :class:`~repro_torch.training.OnlineTrainer` as the
        gateway's patch source: every ``tick``/drain boundary polls it for
        finished patches and installs them via :meth:`install_patch`,
        always between panes, never mid-pane. The trainer's version must
        match the gateway's current model version (both start at 0)."""
        if trainer is not None and trainer.version != self._model_version:
            raise ValueError(
                f"trainer is at version {trainer.version} but the "
                f"gateway serves model version {self._model_version}; "
                f"patches would fail the base-version guard")
        self._trainer = trainer

    def install_patch(self, patch) -> int:
        """Hot-swap a :class:`~repro_torch.training.WeightPatch` into the
        live engine: O(patch), only the patched leaves are written (in
        place, so the engine's captured graphs serve them), and there is
        no checkpoint reload. The patch must be based on the currently
        served version (base-version guard); the install advances the
        model-version axis of the composite cache generation, so every
        state prefilled under the old weights becomes unreachable at once.
        ``patch_policy`` decides their fate: ``"purge"`` drops them;
        ``"rewarm"`` queues their users (MRU-first) for the budgeted
        ``warm_step`` re-prefill under the new weights.

        Only this method advances ``model_version``, and it runs on the
        serving thread between panes, so a pane always scores every row
        under one parameter set. Returns the number of leaves swapped."""
        if patch.base_version != self._model_version:
            raise ValueError(
                f"patch {patch.version} is based on version "
                f"{patch.base_version}, but the gateway serves version "
                f"{self._model_version}; re-emit the patch from the "
                f"served version (patches never skip or rewind)")
        t0 = time.perf_counter()
        n = self.engine.apply_patch(patch.leaves)
        self._model_version = int(patch.version)
        self._patches_applied += 1
        # a params change invalidates the delta-rewarm window too: the
        # retained old-generation states were prefilled under old weights
        self._handoff_from = None
        if self._gen is not None:
            new_vgen = (self._gen[0], self._model_version)
            stale_users = [u for (u, g) in self.cache._entries
                           if g != new_vgen]
            self.cache.invalidate_except(new_vgen)
            if self.cfg.patch_policy == "rewarm":
                self._rewarm_queue = deque(dict.fromkeys(
                    reversed(stale_users)))
            else:
                self._rewarm_queue.clear()
            self._gen = new_vgen
        dt = time.perf_counter() - t0
        if dt > self._patch_install_max_s:
            self._patch_install_max_s = dt
        return n

    def _maybe_install_patches(self) -> int:
        """Drain the attached trainer's finished patches (if any) into the
        engine. Called at the top of ``tick`` and of every queue drain
        (the between-panes boundaries), so a pane in flight never sees a
        version change."""
        tr = self._trainer
        if tr is None:
            return 0
        n = 0
        while True:
            patch = tr.poll_patch()
            if patch is None:
                break
            self.install_patch(patch)
            n += 1
        return n

    # ------------------------------------------------------------------
    # Ingestion (the other half of the facade)
    # ------------------------------------------------------------------

    def _event_user_limit(self) -> int:
        """Max exclusive user id BOTH stores accept. Ingestion validates
        against this *before* any write: the batch log and the realtime
        ring must never diverge on what they absorbed — a half-applied
        event batch would make the merge double-count or drop events
        forever after."""
        limit = self.injector.batch.cfg.n_users
        if self.injector.realtime is not None:
            limit = min(limit, self.injector.realtime.cfg.n_users)
        return limit

    def observe(self, ev) -> None:
        """Ingest one feedback event into both feature stores (offline
        log + realtime stream). Accepts an :class:`Event`, a
        ``(user, item, ts)`` tuple, or any object with those attributes
        — the same hook signature the platform exposes. The user id is
        validated against *both* stores up front so a rejected event
        mutates neither."""
        ev = as_event(ev)
        limit = self._event_user_limit()
        if not 0 <= ev.user < limit:
            raise IndexError(
                f"event user {ev.user} out of range [0, {limit}) for the "
                f"feature stores; nothing was ingested")
        self.injector.batch.append(ev.user, ev.item, ev.ts)
        if self.injector.realtime is not None:
            self.injector.realtime.ingest(ev.user, ev.item, ev.ts)

    def observe_many(self, users, items, tss) -> None:
        """Columnar bulk ingest (parallel arrays) of feedback events.

        The whole batch is validated against BOTH stores before either
        absorbs anything: the batch log's own range check fires before
        it writes, but the realtime store's used to fire only *after*
        the log had already extended — a bad batch left the two stores
        silently diverged (events the merge would count once instead of
        twice, or the reverse). A rejected batch now mutates nothing."""
        users = np.asarray(users, np.int64).ravel()
        items = np.asarray(items).ravel()
        tss = np.asarray(tss).ravel()
        if not (len(users) == len(items) == len(tss)):
            raise ValueError(
                f"observe_many wants parallel arrays; got lengths "
                f"users={len(users)} items={len(items)} ts={len(tss)}")
        if len(users):
            limit = self._event_user_limit()
            lo, hi = int(users.min()), int(users.max())
            if lo < 0 or hi >= limit:
                raise IndexError(
                    f"event user ids out of range [0, {limit}): "
                    f"[{lo}, {hi}]; nothing was ingested")
        self.injector.batch.extend(users, items, tss)
        if self.injector.realtime is not None:
            self.injector.realtime.extend(users, items, tss)

    def tick(self, now: int) -> List[Ticket]:
        """Advance the gateway clock: advance/roll due snapshots (warm
        handoff on a generation change), flush the queue if any pending
        request's deadline has been reached, then spend the configured
        ``rewarm_budget`` re-prefilling users the last rollover
        invalidated. Returns tickets served by a deadline flush
        (usually none)."""
        self._advance(now)
        self._maybe_install_patches()
        self._sync_generation(self._clock)
        if self.cfg.log_compaction is not None:
            self._step_compaction(self._clock)
        served: List[Ticket] = []
        if self._deadline_due():
            self._deadline_flushes += 1
            served = self._drain(full_panes_only=False)
        elif self._wait_exceeded():
            served = self._drain(full_panes_only=False)
        if self.cfg.rewarm_budget:
            self.warm_step(self.cfg.rewarm_budget)
        return served

    def _step_compaction(self, now: Optional[int]) -> None:
        """Tick-driven tiered-log maintenance (``log_compaction``):
        fold elapsed hot-tail windows into warm segments and evict past
        retention, bounding ingest memory. ``"sync"`` compacts inline on
        the tick that finds a window due; ``"background"`` starts an
        off-thread :class:`~repro_torch.core.event_log.BackgroundCompactor`
        build and installs it on a later tick's O(1) poll — either way
        installation happens here, between panes, so no pane ever reads
        a half-swapped tail. The attached trainer's cursor rides along
        as ``keep_from``: events it has not consumed yet are pinned in
        the hot tail (never trimmed or evicted under it), which is what
        keeps ``events_since`` gapless across compaction."""
        log = self.injector.batch._log
        if now is None or log.window is None:
            return
        keep_from = (self._trainer.cursor
                     if self._trainer is not None else None)
        if self.cfg.log_compaction == "background":
            if self._compactor is None:
                from repro_torch.core.event_log import BackgroundCompactor
                self._compactor = BackgroundCompactor(log)
            if self._compactor.active:
                self._compactor.poll()
            elif log.compaction_due(int(now)):
                self._compactor.start(int(now), keep_from=keep_from)
        elif log.compaction_due(int(now)):
            log.compact(int(now), keep_from=keep_from)

    # ------------------------------------------------------------------
    # Submission
    # ------------------------------------------------------------------

    def _check_request(self, req: Request) -> None:
        if req.slate_len is not None and \
                req.slate_len > self.engine.cfg.vocab_size:
            raise ValueError(
                f"request slate_len={req.slate_len} exceeds the engine's "
                f"item vocabulary ({self.engine.cfg.vocab_size})")
        n_users = self.injector.batch.cfg.n_users
        if req.user >= n_users:
            # fail at the call site — inside pane execution this would be
            # a numpy IndexError that takes the whole pane down with it
            raise ValueError(
                f"request user {req.user} is out of range for the "
                f"feature plane (n_users={n_users})")

    def submit(self, request: Request) -> Ticket:
        """Enqueue one arrival. Flushes immediately when the queue
        reaches a full ``max_batch`` pane, or when the arrival's clock
        reaches a pending deadline; otherwise the request waits for
        pane-full / deadline / ``tick`` / ``flush``. With
        ``shed_policy="deadline"`` an arrival whose projected completion
        already exceeds its deadline is rejected here — its ticket
        resolves immediately with the shed marker and never enqueues."""
        self._check_request(request)
        self._advance(request.now)
        t = Ticket(request, self._next_id, time.perf_counter())
        self._next_id += 1
        if self._should_shed(request, len(self._queue)):
            self._shed_ticket(t)
            return t
        self._queue.append(t)
        self._maybe_flush()
        return t

    def submit_many(self, requests: Sequence[Request]) -> List[Ticket]:
        """Enqueue a batch of arrivals that are known together (a wave).

        Unlike per-request ``submit``, the whole batch lands in the
        queue before any pane forms, so the cache-aware partitioning
        sees all of it at once — this is exactly the legacy wave
        semantics, and full panes are flushed eagerly; a short remainder
        stays queued for deadline/flush."""
        for req in requests:
            # validate the WHOLE batch before enqueuing any of it: a bad
            # request mid-batch must not leave earlier rows queued with
            # their ticket handles lost to the exception
            self._check_request(req)
        tickets = []
        for req in requests:
            t = Ticket(req, self._next_id, time.perf_counter())
            self._next_id += 1
            self._advance(req.now)
            if self._should_shed(req, len(self._queue)):
                self._shed_ticket(t)
            else:
                self._queue.append(t)
            tickets.append(t)
        self._maybe_flush()
        return tickets

    def flush(self, now: Optional[int] = None) -> List[Ticket]:
        """Serve everything queued (the last pane padded if short)."""
        self._advance(now)
        return self._drain(full_panes_only=False)

    def poll(self) -> List[Ticket]:
        """Claim every ticket whose row has retired since the last
        ``poll``/``drain`` — the streaming half of the completion API.
        Never blocks and never serves; pair it with ``submit`` (+
        ``tick`` to advance the clock) for a caller loop that consumes
        responses as rows retire instead of holding wave-shaped ticket
        lists. Tickets stay claimable exactly once."""
        out = list(self._completed)
        self._completed.clear()
        return out

    def drain(self, deadline: Optional[int] = None) -> List[Ticket]:
        """Advance the clock to ``deadline`` (when given), serve
        everything still queued (last pane padded if short), and claim
        completions: returns every ticket finished since the last
        ``poll``/``drain`` — the just-served queue plus anything an
        earlier pane-full or deadline flush already retired."""
        self.flush(deadline)
        return self.poll()

    def _deadline_due(self) -> bool:
        if self._clock is None:
            return False
        return any(t.request.deadline is not None
                   and t.request.deadline <= self._clock
                   for t in self._queue)

    def _wait_exceeded(self) -> bool:
        """Continuous admission: some queued request has waited
        ``max_wait`` request-clock units (always true for ``max_wait=0``
        with anything queued)."""
        mw = self.cfg.max_wait
        if mw is None or self._clock is None or not self._queue:
            return False
        return any(self._clock - t.request.now >= mw for t in self._queue)

    # ------------------------------------------------------------------
    # Deadline-aware load shedding (shed_policy="deadline")
    # ------------------------------------------------------------------

    def _projected_done(self, position: int) -> int:
        """Projected completion time of a request at queue ``position``
        (0-based), assuming back-to-back full-pane drains from here on:
        the request rides pane ``position // max_batch`` of the drain,
        and each pane occupies the server for ``pane_service_time`` on
        top of the busy-until marker. This is the *optimistic* drain
        schedule — the queue can only complete later than this (partial
        panes, new arrivals jumping into earlier panes never happen,
        reordering preserves pane count) — so shedding on it never
        rejects a request that could actually have been served in time
        under full panes."""
        cost = self.cfg.pane_service_time
        base = self._busy_until
        if self._clock is not None:
            base = max(base, int(self._clock))
        b = self.engine.scfg.max_batch
        return base + (position // b + 1) * cost

    def _should_shed(self, req: Request, position: int) -> bool:
        """Submit-time admission control: would this request, placed at
        ``position`` in the queue, already complete past its deadline?
        Requests without a deadline are never shed."""
        if self.cfg.shed_policy != "deadline" or req.deadline is None:
            return False
        return self._projected_done(position) > req.deadline

    def _shed_overdue(self) -> List[Ticket]:
        """Flush-time admission recheck, run before panes form: walk
        the queue in order and shed any deadline-carrying request whose
        projected completion — at the position it actually occupies
        after earlier sheds compact the queue — exceeds its deadline.
        Kept requests keep their relative order; returns the shed
        tickets (already resolved and claimable)."""
        kept: List[Ticket] = []
        shed: List[Ticket] = []
        for t in self._queue:
            d = t.request.deadline
            if d is not None and self._projected_done(len(kept)) > d:
                self._shed_ticket(t)
                shed.append(t)
            else:
                kept.append(t)
        self._queue = kept
        return shed

    def _shed_ticket(self, t: Ticket) -> None:
        """Resolve a ticket with the typed shed marker: empty
        slate/scores, telemetry ``path="shed"`` with ``pane_id=-1``,
        claimable through ``poll``/``drain`` like any completion — a
        shed ticket must never block a caller draining the stream. Shed
        rows count in ``stats().shed``, not in ``paths`` (they were
        never served) and not in the queue-delay percentiles."""
        now = int(self._clock) if self._clock is not None else t.request.now
        tel = RequestTelemetry(
            request_id=t.request_id, user=t.request.user,
            policy=self._policy_of(t.request),
            slate_len=t.request.slate_len or self.cfg.slate_len,
            pane_id=-1, queue_delay=max(0, now - t.request.now),
            cache_hit=False, path="shed",
            generation=self._gen[0] if self._gen is not None else -1,
            submitted_at=t.request.now, served_at=now, tag=t.request.tag,
            model_version=self._model_version)
        t.response = Response(slate=np.empty(0, np.int32),
                              scores=np.empty(0, np.float32),
                              telemetry=tel, shed=True)
        t.completed_wall = time.perf_counter()
        self._completed.append(t)
        self.shed += 1

    def _maybe_flush(self) -> None:
        """The one flush-trigger policy for every enqueue path: a due
        deadline drains everything (padded short pane); a request past
        the continuous-mode ``max_wait`` likewise drains everything —
        the queue it drains is whatever is known at that moment, so a
        ``submit_many`` wave still forms full panes while per-arrival
        ``submit`` serves immediately; otherwise a full pane's worth of
        queued requests drains eagerly."""
        if self._deadline_due():
            self._deadline_flushes += 1
            self._drain(full_panes_only=False)
        elif self._wait_exceeded():
            self._drain(full_panes_only=False)
        elif len(self._queue) >= self.engine.scfg.max_batch:
            self._drain(full_panes_only=True)

    # ------------------------------------------------------------------
    # The scheduler core
    # ------------------------------------------------------------------

    def _row_cacheable(self, policy: str) -> bool:
        # "fresh" histories move with the serve clock (cache-key
        # invariant); "decay" rows never build an engine state at all
        return self.cfg.use_cache and policy not in ("fresh", "decay")

    def _policy_of(self, req: Request) -> str:
        return req.policy or self.injector.cfg.policy

    def _drain(self, full_panes_only: bool) -> List[Ticket]:
        """Form and serve panes from the queue.

        Cache-aware pane formation: when more than one pane is queued,
        rows are stably partitioned hits-first over the *whole* queue
        (uncacheable rows sort with the misses) before slicing into
        fixed ``max_batch`` panes — one cold row in a pane of hits would
        otherwise drag the whole pane onto the prefill path. Rows are
        independent, so regrouping cannot change any result.
        """
        self._maybe_install_patches()
        if not self._queue:
            return []
        now = self._clock
        gen = self._sync_generation(now)
        shed: List[Ticket] = []
        if self.cfg.shed_policy == "deadline":
            # shed before panes form (and before the cache-aware
            # reorder): a request that cannot make its deadline must
            # not occupy a pane row a viable request could ride
            shed = self._shed_overdue()
            if not self._queue:
                return shed
        b = self.engine.scfg.max_batch
        q = self._queue
        if len(q) > b:
            is_miss = np.array([
                not self._row_cacheable(self._policy_of(t.request))
                or (t.request.user, gen) not in self.cache
                for t in q])
            order = np.argsort(is_miss, kind="stable")  # hits first
            q = [q[i] for i in order]
        # adopt the (possibly reordered) queue up front and dequeue pane
        # by pane AS each one serves: if a later pane raises, the served
        # tickets are already out of the queue — a retried flush must
        # never re-execute a pane whose responses the caller may hold
        self._queue = q
        served: List[Ticket] = shed
        while len(self._queue) >= b:
            pane = self._queue[:b]
            self._execute(pane, gen)
            self._queue = self._queue[b:]
            served.extend(pane)
        if not full_panes_only and self._queue:
            pane = list(self._queue)
            self._execute(pane, gen)
            self._queue = []
            served.extend(pane)
        return served

    # ------------------------------------------------------------------
    # Feature -> token assembly (per-row policy and clock)
    # ------------------------------------------------------------------

    def _histories(self, reqs: Sequence[Request], policies: Sequence[str],
                   now: int) -> List[List[int]]:
        """Per-row batch-history token lists, read at the pane's serve
        clock ``now``. Features are **serve-time**, not arrival-time: a
        pane is assembled once, when it executes, against the freshest
        store state available — which is also what keeps a mixed pane at
        one store lookup per history flavor ("batch"/"inject" share the
        snapshot prefix; "fresh" reads at the serve cutoff) instead of
        one per distinct arrival time."""
        out: List[Optional[List[int]]] = [None] * len(reqs)
        groups: "OrderedDict[bool, List[int]]" = OrderedDict()
        for i, pol in enumerate(policies):
            groups.setdefault(pol == "fresh", []).append(i)
        for fresh, rows in groups.items():
            users = np.asarray([reqs[i].user for i in rows], np.int64)
            if fresh:
                items, _, valid = self.injector.batch.lookup_at_cutoff(
                    users, now)
            else:
                items, _, valid = self.injector.batch.lookup(users, now)
            toks = items_to_tokens(items, valid)
            for j, i in enumerate(rows):
                out[i] = toks[j][valid[j] > 0].tolist()
        return out  # type: ignore[return-value]

    def _suffixes(self, reqs: Sequence[Request], policies: Sequence[str],
                  now: int) -> List[List[int]]:
        """Per-row fresh-suffix token lists at the serve clock; only
        "inject" rows carry one (a single ``fresh_suffix_tokens`` call
        per pane, capped at inject_len newest events — see its docstring
        for why truncation happens before tokenization)."""
        out: List[List[int]] = [[] for _ in reqs]
        if self.injector.realtime is None:
            return out
        rows = [i for i, pol in enumerate(policies) if pol == "inject"]
        if not rows:
            return out
        users = np.asarray([reqs[i].user for i in rows], np.int64)
        sfx = self.injector.fresh_suffix_tokens(
            users, now, cap=self.engine.scfg.inject_len)
        for j, i in enumerate(rows):
            out[i] = sfx[j]
        return out

    # ------------------------------------------------------------------
    # Pane execution
    # ------------------------------------------------------------------

    def _execute(self, pane: List[Ticket], gen: Tuple[int, int]) -> None:
        eng = self.engine
        pane_id = self.panes
        self.panes += 1
        reqs = [t.request for t in pane]
        now = int(self._clock)  # serve-time feature clock for the pane
        policies = [self._policy_of(r) for r in reqs]
        slate_lens = [r.slate_len or self.cfg.slate_len for r in reqs]
        # per-pane-row results, scattered by the policy branches below
        row_slate: List[Optional[np.ndarray]] = [None] * len(reqs)
        row_scores: List[Optional[np.ndarray]] = [None] * len(reqs)
        hit_all = [False] * len(reqs)
        path_all = [""] * len(reqs)

        # "decay" rows are served model-free (no engine state, no cache
        # entry): slates ranked by exponentially time-decayed event
        # scores over the row's cutoff-exact features. Carved out here
        # so the engine pane below only carries model-scored rows —
        # rows are independent, so the split cannot change any result.
        drows = [i for i, p in enumerate(policies) if p == "decay"]
        if drows:
            self._serve_decay(reqs, drows, slate_lens, now,
                              row_slate, row_scores, path_all)
        erows = [i for i, p in enumerate(policies) if p != "decay"]
        if erows:
            self._serve_engine(reqs, erows, policies, slate_lens, gen, now,
                               row_slate, row_scores, hit_all, path_all)

        # service model: with pane_service_time set, this pane occupies
        # the server for `cost` sim-seconds past whenever it frees up —
        # completion times (and therefore queue delays and deadline
        # misses) account for the backlog, not just the flush clock
        cost = self.cfg.pane_service_time
        if cost is None:
            done_at = int(self._clock)
        else:
            self._busy_until = max(self._busy_until, int(self._clock)) + cost
            done_at = self._busy_until
        wall = time.perf_counter()
        for i, (t, pol) in enumerate(zip(pane, policies)):
            tel = RequestTelemetry(
                request_id=t.request_id, user=t.request.user, policy=pol,
                slate_len=slate_lens[i], pane_id=pane_id,
                # clamped at 0: the deprecated legacy shim rewinds the
                # otherwise-monotonic clock for non-monotonic serve(now)
                # replays, and a pending request from a later wave would
                # otherwise record a negative delay and pollute the
                # stats() queue-delay percentiles
                queue_delay=max(0, int(done_at - t.request.now)),
                cache_hit=hit_all[i], path=path_all[i], generation=gen[0],
                submitted_at=t.request.now, served_at=done_at,
                tag=t.request.tag, model_version=gen[1])
            t.response = Response(slate=row_slate[i], scores=row_scores[i],
                                  telemetry=tel)
            t.completed_wall = wall
            if t.request.deadline is not None \
                    and done_at > t.request.deadline:
                self.deadline_misses += 1
            self._path_counts[path_all[i]] += 1
            self._queue_delays.append(tel.queue_delay)
        self._completed.extend(pane)  # rows retire -> claimable via poll()
        self.requests += len(pane)

    def _serve_decay(self, reqs: Sequence[Request], rows: Sequence[int],
                     slate_lens: Sequence[int], now: int,
                     row_slate: List, row_scores: List,
                     path_all: List[str]) -> None:
        """Model-free serving for policy "decay": one cutoff-exact
        feature lookup for the pane's decay rows, per-item scores
        ``sum(0.5 ** (age / half_life))``, slate = highest-scoring
        distinct items (ties broken item-ascending — the stable argsort
        over negated scores — so slates are deterministic wherever the
        features are)."""
        users = np.asarray([reqs[i].user for i in rows], np.int64)
        feats = self.injector.batch.lookup_at_cutoff(users, now)
        sc = decay_scores(feats, now, self.injector.cfg.half_life,
                          self.engine.cfg.vocab_size)
        for j, i in enumerate(rows):
            order = np.argsort(-sc[j], kind="stable")
            row_slate[i] = order[:slate_lens[i]].astype(np.int32)
            row_scores[i] = sc[j].astype(np.float32)
            path_all[i] = "decay"

    def _serve_engine(self, reqs: Sequence[Request], rows: Sequence[int],
                      policies: Sequence[str], slate_lens: Sequence[int],
                      gen: Tuple[int, int], now: int,
                      row_slate: List, row_scores: List,
                      hit_all: List[bool], path_all: List[str]) -> None:
        """The model-scored pane body (every non-"decay" row)."""
        eng = self.engine
        ereqs = [reqs[i] for i in rows]
        epol = [policies[i] for i in rows]
        elens = [slate_lens[i] for i in rows]
        suffix = self._suffixes(ereqs, epol, now)
        cacheable = [self._row_cacheable(p) for p in epol]
        if self.cfg.delta_rewarm:
            # deferred-delta entries (O(delta) re-warm): the snapshot
            # delta the entry skipped at rekey time rides ahead of the
            # row's realtime suffix in the SAME inject — token-for-token
            # the stream the pre-rollover path would have injected. The
            # entry is read-only (states are never written back), so the
            # pending tokens stay attached until the entry is evicted or
            # the next handoff sweeps it. Peek without touching LRU
            # order or hit/miss counters; the cache probe happens next.
            cap = eng.scfg.inject_len
            for i, (req, can) in enumerate(zip(ereqs, cacheable)):
                if not can:
                    continue
                pending = self.cache.get_pending(req.user, gen)
                if not pending:
                    continue
                combined = list(pending) + suffix[i]
                if len(combined) <= cap:
                    suffix[i] = combined
                else:
                    # delta + fresh events outgrew one inject: the
                    # deferral no longer pays — fall back to a full
                    # prefill for this user (drop makes the row a miss)
                    self.cache.drop(req.user, gen)

        if not any(cacheable):
            # pure-uncacheable pane (policy "fresh", or caching off):
            # one prefill of history[-prefill_len:] + suffix per row —
            # truncating BEFORE the append keeps this path's token
            # streams identical to the cached path's prefill pane even
            # when the feature history is longer than prefill_len. A
            # suffix-free pane pads to prefill_len exactly: that puts
            # its rows at the same right-aligned RoPE offsets as the
            # cacheable path's prefill pane, so a row's scores don't
            # depend on which pane composition served it (the
            # continuous scheduler's partial panes must be bitwise
            # equal to the wave path's mixed panes).
            hists = self._histories(ereqs, epol, now)
            p = eng.scfg.prefill_len
            streams = [h[-p:] + s for h, s in zip(hists, suffix)]
            buf = p + (eng.scfg.inject_len if any(suffix) else 0)
            toks, valid = eng.pad_tokens(streams, buf)
            # the pane reads only the last position's logits
            state = eng.prefill(toks, valid, logits_last_only=True)
            self.prefill_calls += 1
            first = state["logits"][:, -1]
            hit_flags = [False] * len(ereqs)
            paths = ["prefill"] * len(ereqs)
        else:
            if self.pool is not None:
                state, last, hit_flags = self._assemble_pool(
                    ereqs, epol, cacheable, gen, now)
            else:
                entries, hit_flags = self._lookup_or_admit(
                    ereqs, epol, cacheable, gen, now)
                state = _cat_rows(entries, eng.scfg.max_batch, eng.device,
                                  eng.row_block())
                last = _join([e["last_logits"] for e in _pad_list(
                    entries, eng.scfg.max_batch)], 0, eng.device, stack=True)
            if any(suffix):
                stoks, svalid = eng.pad_tokens(suffix, eng.scfg.inject_len,
                                               align="left")
                # the cached pre-inject scores ride along as the
                # fallback, so per-row "last fresh event vs empty
                # suffix" selection happens inside inject on the
                # device — no logits ever sync to pick them
                state = eng.inject(state, stoks, svalid, fallback_logits=last)
                self.inject_calls += 1
                first = state["first_logits"]
            else:
                first = last
            paths = ["prefill" if not h else ("inject" if s else "cached")
                     for h, s in zip(hit_flags, suffix)]

        slate, _ = self._decode(state, first, elens)
        scores = eng.full_rows(first).to(torch.float32).cpu().numpy()
        for j, i in enumerate(rows):
            row_slate[i] = slate[j, :elens[j]].copy()
            row_scores[i] = scores[j].copy()
            hit_all[i] = hit_flags[j]
            path_all[i] = paths[j]

    def _decode(self, state: Dict[str, Any], first_logits,
                slate_lens: Sequence[int]) -> Tuple[np.ndarray, int]:
        """finalize -> greedy slate, one engine call for the whole pane.

        Uniform panes (every row on the configured default) take the
        exact decode the wave path always ran; heterogeneous slate_lens
        decode to the pane max with per-row tails masked to -1 on the
        device (see ServingEngine.decode_slate)."""
        eng = self.engine
        max_len = max(slate_lens)
        if all(sl == slate_lens[0] for sl in slate_lens):
            slate = eng.decode_slate(state, first_logits, max_len)
        else:
            b = eng.scfg.max_batch
            row_lens = np.full(b, max_len, np.int32)
            row_lens[:len(slate_lens)] = slate_lens
            slate = eng.decode_slate(state, first_logits, max_len,
                                     row_lens=row_lens)
        self.decode_steps += max_len - 1
        return slate, max_len

    @staticmethod
    def _probe(reqs: Sequence[Request], policies: Sequence[str],
               cacheable: Sequence[bool], gen, lookup,
               ) -> Tuple[Dict[Any, Any], List[bool], List[Any], List[Any],
                          List[int]]:
        """The per-row cache probe of both backends. Cacheable rows call
        ``lookup(user, gen)`` once per ROW (not per unique user) so
        hit/miss counters stay in request units even when a pane repeats
        a user; misses and uncacheable rows (keyed ``(user, policy,
        "ephemeral")``) form one deduplicated admission list. Returns
        ``(found {key: lookup result}, hit_flags, row keys, miss keys,
        miss rows)``."""
        found: Dict[Any, Any] = {}
        hit_flags: List[bool] = []
        keys: List[Any] = []
        miss_seen = set()
        miss_keys: List[Any] = []
        miss_rows: List[int] = []
        for i, (req, pol, can) in enumerate(zip(reqs, policies, cacheable)):
            key = req.user if can else (req.user, pol, "ephemeral")
            value = lookup(req.user, gen) if can else None
            if value is not None:
                found[key] = value
            elif key not in miss_seen:
                miss_seen.add(key)
                miss_keys.append(key)
                miss_rows.append(i)
            hit_flags.append(value is not None)
            keys.append(key)
        return found, hit_flags, keys, miss_keys, miss_rows

    def _prefill_rows(self, reqs: Sequence[Request],
                      policies: Sequence[str], rows: Sequence[int],
                      now: int) -> Dict[str, Any]:
        """One fixed-shape prefill of ``rows``' batch histories, the
        pane's admissions (last-position logits only)."""
        eng = self.engine
        hists = self._histories([reqs[i] for i in rows],
                                [policies[i] for i in rows], now)
        toks, valid = eng.pad_tokens(hists, eng.scfg.prefill_len)
        state = eng.prefill(toks, valid, logits_last_only=True)
        self.prefill_calls += 1
        return state

    def _lookup_or_admit(self, reqs: Sequence[Request],
                         policies: Sequence[str],
                         cacheable: Sequence[bool], gen: int, now: int,
                         ) -> Tuple[List[Dict[str, Any]], List[bool]]:
        """Per-row prefill states, admitting all misses in ONE
        fixed-shape batch prefill (one prefill per pane worst case).

        Cacheable rows probe the LRU once per ROW (hit/miss counters
        stay in request units even when a pane repeats a user) and
        misses are admitted under the ``(user, generation)`` key.
        Uncacheable rows in a mixed pane (policy "fresh") are admitted
        *ephemerally* in the same prefill batch — their history is read
        at the serve cutoff, which moves with the clock, so caching them
        would violate the cache-key invariant; they are keyed by
        (user, policy) for intra-pane dedup only (one pane = one serve
        clock).
        """
        entries, hit_flags, keys, miss_keys, miss_rows = self._probe(
            reqs, policies, cacheable, gen, self.cache.get)
        if miss_rows:
            state = self._prefill_rows(reqs, policies, miss_rows, now)
            # one device→host sync per leaf, of every row on a mesh
            host = _host_state(self.engine.full_pane(state))
            for j, (key, i) in enumerate(zip(miss_keys, miss_rows)):
                entry = _slice_row(host, j)
                if cacheable[i]:
                    self.cache.put(reqs[i].user, gen, entry)
                entries[key] = entry
        return [entries[k] for k in keys], hit_flags

    def _assemble_pool(self, reqs: Sequence[Request],
                       policies: Sequence[str],
                       cacheable: Sequence[bool], gen: int, now: int,
                       gather: bool = True,
                       ) -> Tuple[Optional[Dict[str, Any]], Any, List[bool]]:
        """Pooled twin of ``_lookup_or_admit`` + ``_cat_rows``: per-row
        slot resolution, one fixed-shape prefill for all misses
        scattered straight into pool slots, then a gather assembling the
        pane on the device — no state ever visits the host.

        Probe/admission order, dedup, and the ephemeral treatment of
        uncacheable rows mirror the host path exactly (the two backends
        must stay bitwise-equal and counter-identical). Slots touched by
        this pane — hits and fresh admissions — are *pinned* so
        slot-pressure eviction during admission can never free a slot
        the pane is about to read; scratch slots of ephemeral rows
        return to the free list once the pane is assembled. With
        ``gather=False`` (the warming path) admission happens but no
        pane is assembled."""
        cache = self.cache  # PagedStateCache
        slot_of, hit_flags, keys, miss_keys, miss_rows = self._probe(
            reqs, policies, cacheable, gen, cache.lookup)
        pinned = set(slot_of.values())
        scratch: List[int] = []
        if miss_rows:
            state = self._prefill_rows(reqs, policies, miss_rows, now)
            for key, i in zip(miss_keys, miss_rows):
                if cacheable[i]:
                    s = cache.admit(reqs[i].user, gen, pinned)
                else:
                    s = cache.alloc_scratch(pinned)
                    scratch.append(s)
                pinned.add(s)
                slot_of[key] = s
            self.pool.scatter(self.engine.full_pane(state),
                              [slot_of[k] for k in miss_keys])
        pane = last = None
        if gather:
            # short panes pad by repeating row 0's slot inside gather —
            # the same padding rows (and therefore bitwise the same pane)
            # as the host path's _pad_list; padding is discarded after
            # decode
            pane, last = self.pool.gather([slot_of[k] for k in keys])
        for s in scratch:
            cache.free_scratch(s)
        return pane, last, hit_flags

    # ------------------------------------------------------------------
    # Warming
    # ------------------------------------------------------------------

    def _admit_users(self, users, gen: int, now: int) -> Tuple[int, bool]:
        """Admit ``users``' batch-history prefill states in fixed
        ``max_batch`` panes (no serving). Returns ``(prefilled,
        evicted)`` — stops after the first pane whose admission evicts:
        a full cache budget means further warming would only evict
        states we just paid to prefill. Shared by ``warm`` (daily-job
        precompute) and ``warm_step`` (post-rollover re-warm) so the
        admission semantics cannot drift between them."""
        pol = self.injector.cfg.policy
        b = self.engine.scfg.max_batch
        warmed = 0
        # evicting a RETAINED dual-generation entry is not budget
        # pressure — those are the designated victims of the handoff
        # window; only a live-entry eviction means the budget refilled
        ev0 = self.cache.evictions - self.cache.stale_evictions
        for lo in range(0, len(users), b):
            pane = [Request(user=int(u), now=int(now))
                    for u in users[lo:lo + b]]
            before = self.cache.misses
            if self.pool is not None:
                self._assemble_pool(pane, [pol] * len(pane),
                                    [True] * len(pane), gen, int(now),
                                    gather=False)
            else:
                self._lookup_or_admit(pane, [pol] * len(pane),
                                      [True] * len(pane), gen, int(now))
            warmed += self.cache.misses - before
            if self.cache.evictions - self.cache.stale_evictions > ev0:
                return warmed, True
        return warmed, False

    def warm(self, users, now: int) -> int:
        """Cache-warming pass: admit ``users``' batch-history prefill
        states without serving — the post-snapshot precompute a daily job
        runs so live traffic starts on the inject-only path. Returns the
        number of states prefilled. No-op when caching is off or the
        policy is uncacheable. Clamped to the first ``cache_entries``
        users (pass highest-priority users first), and stops early once
        the byte budget is full — warming past either budget would
        prefill states that LRU-evict before they serve."""
        users = np.asarray(users, np.int64).ravel()[:self.cache.budget]
        if not self.cfg.use_cache \
                or self.injector.cfg.policy in ("fresh", "decay"):
            return 0
        self._advance(now)
        gen = self._sync_generation(now)
        warmed, _ = self._admit_users(users, gen, int(now))
        return warmed

    def warm_step(self, budget: Optional[int] = None) -> int:
        """Budget-bounded post-rollover re-warm: prefill up to ``budget``
        users whose cached states the last generation handoff invalidated
        (MRU-first — the hottest users are the likeliest next arrivals),
        skipping any the live traffic already re-admitted. Run between
        panes (``tick`` drives it when ``rewarm_budget`` is set) so the
        post-rollover miss storm drains on idle clock instead of on live
        requests. Returns the number of states prefilled."""
        if budget is None:
            budget = self.cfg.rewarm_budget
        if budget <= 0 or not self._rewarm_queue:
            return 0
        if not self.cfg.use_cache \
                or self.injector.cfg.policy in ("fresh", "decay") \
                or self._clock is None:
            return 0
        gen = self._gen
        users: List[int] = []
        delta_done = 0
        while self._rewarm_queue and len(users) + delta_done < budget:
            u = self._rewarm_queue.popleft()
            if (u, gen) in self.cache:
                continue
            if self._try_delta_rewarm(int(u), gen):
                delta_done += 1
            else:
                users.append(int(u))
        warmed, evicted = self._admit_users(users, gen, int(self._clock))
        if evicted:
            # a cache budget is full again — live traffic refilled it.
            # Re-warming further would only evict resident (possibly
            # just-rewarmed) states, so the storm is over: drop the
            # rest of the queue, or every subsequent tick would repeat
            # this churn
            self._rewarm_queue.clear()
        self._rollover["rebuilt"] += warmed
        self._rollover["delta_rewarms"] += delta_done
        return warmed + delta_done

    def _try_delta_rewarm(self, u: int, new_vgen: Tuple[int, int]) -> bool:
        """O(delta) re-warm (``ServerConfig.delta_rewarm``): when a
        changed user's NEW snapshot row strictly extends their old row
        (append-only history, no retention trim), the retained
        old-generation entry already holds a prefill of a prefix of the
        new history — so instead of paying a fresh ``prefill_len``-wide
        prefill, rekey the retained entry to the new generation and
        attach the (new - old) delta as **pending inject tokens**. The
        serve path prepends them to the row's realtime suffix: one
        inject of ``delta + fresh`` on the old state is token-for-token
        the computation the pre-rollover gateway would have run (the
        delta events WERE that gateway's realtime suffix), so slates
        and scores are bitwise what serving across no rollover yields.

        Qualifies only inside the certified handoff window
        (``_handoff_from``), same model version on both sides, the old
        entry still resident, both snapshot rows still materialized,
        strict-prefix rows, the new row within ``prefill_len``, and the
        combined pending within ``inject_len``. Anything else falls
        back to the full re-warm prefill. The cache is reached only
        through its ``has_entry``/``get_pending``/``set_pending``
        surface, so the entry's state never moves. Returns True when the
        entry was rekeyed in place."""
        if not self.cfg.delta_rewarm:
            return False
        hf = self._handoff_from
        if hf is None or hf[1] != new_vgen:
            return False
        old_vgen = hf[0]
        if not self.cache.has_entry(u, old_vgen):
            return False
        store = self.injector.batch
        old_rows = store.snapshot_rows(old_vgen[0], [u])
        new_rows = store.snapshot_rows(new_vgen[0], [u])
        if old_rows is None or new_rows is None:
            return False
        o_items, _, o_valid = old_rows
        n_items, _, n_valid = new_rows
        o = o_items[0][o_valid[0] > 0]
        n = n_items[0][n_valid[0] > 0]
        if len(n) < len(o) or not np.array_equal(n[:len(o)], o):
            return False  # trimmed or rewritten row: prefix broken
        if len(n) > self.engine.scfg.prefill_len:
            return False  # fresh prefill would clip differently
        d = len(n) - len(o)
        pending = list(self.cache.get_pending(u, old_vgen) or ())
        if d:
            pending += items_to_tokens(
                n[len(o):], np.ones(d, np.int64)).tolist()
        if len(pending) > self.engine.scfg.inject_len:
            return False
        if not self.cache.rekey_entry(u, old_vgen, new_vgen):
            return False
        self.cache.set_pending(u, new_vgen, pending)
        return True

    # ------------------------------------------------------------------
    def stats(self) -> GatewayStats:
        """Counters + aggregated request telemetry as a typed frozen
        :class:`~repro_torch.serving.api.GatewayStats` (``.as_dict()`` for the
        JSON view; ``["key"]`` indexing still works for dict-era
        callers)."""
        delays = np.asarray(self._queue_delays, np.int64)
        return GatewayStats(
            requests=self.requests, panes=self.panes,
            pending=len(self._queue),
            completed=len(self._completed),
            prefill_calls=self.prefill_calls,
            inject_calls=self.inject_calls,
            decode_steps=self.decode_steps,
            deadline_flushes=self._deadline_flushes,
            shed=self.shed,
            deadline_misses=self.deadline_misses,
            paths=dict(self._path_counts),
            queue_delay={
                "window": int(len(delays)),
                "p50": float(np.percentile(delays, 50)) if len(delays) else 0.0,
                "p99": float(np.percentile(delays, 99)) if len(delays) else 0.0,
                "max": int(delays.max()) if len(delays) else 0,
            },
            rollover=RolloverStats(
                **self._rollover,
                pending_build_users=(self._builder.remaining
                                     if self._builder is not None else 0),
                pending_rewarm=len(self._rewarm_queue),
            ),
            cache=self.cache.stats(),
            ingest=self.injector.batch._log.ingest_stats(),
            model_version=self._model_version,
            patches_applied=self._patches_applied,
            patch_install_max_ms=self._patch_install_max_s * 1e3,
        )


# ----------------------------------------------------------------------
# Per-row state plumbing (batch axis of every cache leaf is axis 1, behind
# the layer-repeat axis R: attention K/V and SSM conv tails and state)
#
# Entries are HOST-resident CPU tensors, as the JAX package keeps host
# numpy: a miss pane's state crosses device->host once per cache leaf, its
# rows are cloned out of it (an entry never shares storage with a pane
# that inject or decode_slate later writes), and every pane is assembled
# by host concats and crosses host->device once per leaf. On a CUDA
# engine both crossings go through pinned memory; the host->device copy
# is asynchronous on the current stream, ahead of the inject that reads
# it. The paged pool (serving/pool.py) replaces all of this with indexed
# copies on the device.
# ----------------------------------------------------------------------

def _to_host(x: torch.Tensor) -> torch.Tensor:
    """``x`` on the host. A CUDA tensor lands in pinned memory, whose
    allocator reuses its blocks: a pageable copy pays a bounce buffer and
    the first touch of every fresh page."""
    if x.device.type != "cuda":
        return x
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return out.copy_(x)


def _host_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """Pull a batched sequence-form prefill state to host, whole-pane at a
    time (one device→host sync per cache leaf, not per row)."""
    return {
        "caches": _tree_map(_to_host, state["caches"]),
        "valid": _to_host(state["valid"]),
        "next_pos": _to_host(state["next_pos"]),
        "last_logits": _to_host(state["logits"][:, -1]),
    }


def _slice_row(host: Dict[str, Any], row: int) -> Dict[str, Any]:
    """One row of a host-form pane state, cloned so the entry doesn't pin
    the whole pane's buffers in the LRU (nor share storage with them)."""
    return {
        "caches": _tree_map(lambda x: x[:, row:row + 1].clone(),
                            host["caches"]),
        "valid": host["valid"][row:row + 1].clone(),
        "next_pos": host["next_pos"][row:row + 1].clone(),
        "last_logits": host["last_logits"][row].clone(),
    }


def _pad_list(entries: List[Dict[str, Any]], b: int) -> List[Dict[str, Any]]:
    if not entries:
        raise ValueError("empty pane")
    return entries + [entries[0]] * (b - len(entries))


def _join(xs: Sequence[torch.Tensor], dim: int, device: torch.device,
          stack: bool = False) -> torch.Tensor:
    """Concatenate (or stack) host tensors into one new tensor on
    ``device``: on a CUDA device through pinned memory and one
    asynchronous copy, on the CPU in place."""
    join = torch.stack if stack else torch.cat
    if device.type != "cuda":
        return join(xs, dim=dim)
    shape = list(xs[0].shape)
    if stack:
        shape.insert(dim, len(xs))
    else:
        shape[dim] = sum(x.shape[dim] for x in xs)
    out = torch.empty(shape, dtype=xs[0].dtype, pin_memory=True)
    join(xs, dim=dim, out=out)
    return out.to(device, non_blocking=True)


def _cat_rows(entries: List[Dict[str, Any]], b: int,
              device: torch.device, block: slice = slice(None),
              ) -> Dict[str, Any]:
    """Assemble per-user entries into one max_batch engine state on
    ``device`` (short panes padded by repeating row 0; padding rows are
    discarded later), or the ``block`` of its rows that a mesh rank
    computes. Every leaf is a new tensor."""
    rows = _pad_list(entries, b)[block]
    return {
        "caches": _tree_map(lambda *xs: _join(xs, 1, device),
                            *[e["caches"] for e in rows]),
        "valid": _join([e["valid"] for e in rows], 0, device),
        "next_pos": _join([e["next_pos"] for e in rows], 0, device),
        "logits": None,  # per-row slices don't keep full prefill logits
    }
