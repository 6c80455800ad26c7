"""Paged device-resident prefill-state pool (vLLM-style paging for ITFI).

The host LRU (`scheduler.PrefillStateCache`) keeps per-user prefill
states as CPU tensors and re-assembles every pane with host concats — one
host->device copy per leaf and pane, per admission AND per hit. This
module is the device-resident successor: one **preallocated pool** of
``n_slots`` prefill-state slots lives on the engine's device for the
engine's lifetime, and pane assembly and writeback are slot-indexed
copies on the device:

    gather:  pane_row[b] = pool[slots[b]]      (index_select, new tensors)
    scatter: pool[slots[b]] = pane_row[b]      (index_copy_, in place)

Both are exact copies in every dtype (bool ``valid`` and int32
``next_pos`` included), so a gathered row is bit-identical to the slot
contents and a scattered slot to the pane row: the pooled Gateway serves
slates bitwise equal to the host-LRU Gateway's. ``gather`` always returns
new tensors — ``inject`` and ``decode_slate`` write into the pane they
are given, and nothing but ``scatter`` may ever write a slot. The slot
ids of a call cross to the device as one small int64 tensor.

Only **prefill** states are pooled (sequence length fixed at
``prefill_len``): post-inject states grow the sequence axis and are
never written back, which is exactly the cache-key invariant — an entry
keyed ``(user, generation)`` is a pure function of the user's
snapshot-row history and the params; fresh suffixes never enter a slot.

:class:`PagedStateCache` is the slot table on top: an LRU mapping
``(user, generation) -> slot`` with a free-slot allocator,
slot-pressure eviction (a full pool IS the byte budget: fixed slots =
fixed bytes), and the same counter/rekey surface as the host
``PrefillStateCache`` — so the warm handoff composes unchanged:
``rekey_generation`` renames slot-table keys and **never touches the
device tensors**.

On a device mesh the pool is laid out by ``slot_pool_pspecs``: the slot
axis is replicated over ``data`` (every rank holds every slot) and the
model dims are the rank's shards, as in ``seq_cache_pspecs``. ``gather``
reads only the rank's rows of the pane from its own copy, and
``scatter`` writes every row of the whole prefill pane (which the caller
all-gathers over ``data``, ``engine.full_pane``) into every rank's copy:
neither runs a collective (``tools/torch_slot_pool_check.py``). ``slot_nbytes`` counts a
slot as one device would hold it (``ServingEngine.logical_nbytes``), so
``stats()`` is the same on every mesh. The JAX package does the same
with one-hot contractions; indexed copies need none.
"""
from __future__ import annotations

from collections import OrderedDict, deque
from typing import Any, Dict, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from repro_torch.serving.engine import ServingEngine, _tree_map


# ----------------------------------------------------------------------
# The pool
# ----------------------------------------------------------------------

class DeviceStatePool:
    """Preallocated device tensors for ``n_slots`` prefill-state rows.

    Shapes and dtypes come from ``engine.prefill_state_shapes()`` (one
    real row of prefill, so the pool can never drift from what prefill
    produces): every cache leaf with ``n_slots`` on axis 1, ``valid``
    ``(n_slots, prefill_len)`` bool, ``next_pos`` ``(n_slots,)`` int32
    and ``last_logits`` ``(n_slots, Vp)`` in the prefill logits' dtype.
    ``scatter`` updates them in place: one pool-sized working set, never
    two.
    """

    def __init__(self, engine: ServingEngine, n_slots: int):
        b = engine.scfg.max_batch
        if n_slots < b:
            raise ValueError(
                f"pool_slots={n_slots} must be >= max_batch={b}: a single "
                f"pane can pin one slot per row during assembly")
        self.engine = engine
        self.n_slots = int(n_slots)
        self.data_shards = engine.data_shards
        logits_s, caches_s = engine.prefill_state_shapes()
        p = engine.scfg.prefill_len
        vp = logits_s.shape[-1]

        def alloc(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=engine.device)

        self.caches = _tree_map(
            lambda s: alloc((s.shape[0], self.n_slots) + s.shape[2:],
                            s.dtype), caches_s)
        self.valid = alloc((self.n_slots, p), torch.bool)
        self.next_pos = alloc((self.n_slots,), torch.int32)
        self.last_logits = alloc((self.n_slots, vp), logits_s.dtype)
        self.slot_nbytes = engine.logical_nbytes(
            {"caches": self.caches, "valid": self.valid,
             "next_pos": self.next_pos, "last_logits": self.last_logits}
        ) // self.n_slots
        self.gathers = 0
        self.scatters = 0

    # ------------------------------------------------------------------
    def _index(self, slots: Sequence[int]) -> torch.Tensor:
        b = self.engine.scfg.max_batch
        if len(slots) > b:
            raise ValueError(f"{len(slots)} rows exceed max_batch={b}")
        return torch.tensor(slots, dtype=torch.int64,
                            device=self.engine.device)

    def gather(self, slots: Sequence[int]) -> Tuple[Dict[str, Any],
                                                    torch.Tensor]:
        """Assemble a pane from slot ids (row ``i`` reads ``slots[i]``;
        short panes pad by repeating ``slots[0]``). Returns
        ``(state, last)``: a sequence-form engine state of new tensors
        plus the per-row pre-inject next-item logits. On a mesh ``state``
        holds the rank's rows of the pane and ``last`` every row."""
        b = self.engine.scfg.max_batch
        if not slots:
            raise ValueError("gather of an empty pane")
        pane = list(slots) + [slots[0]] * (b - len(slots))
        idx = self._index(pane[self.engine.row_block()])
        state = {"caches": _tree_map(lambda x: x.index_select(1, idx),
                                     self.caches),
                 "valid": self.valid.index_select(0, idx),
                 "next_pos": self.next_pos.index_select(0, idx),
                 "logits": None}
        last = self.last_logits.index_select(0, self._index(pane))
        self.gathers += 1
        return state, last

    def scatter(self, state: Dict[str, Any], slots: Sequence[int]) -> None:
        """Write prefill-pane rows into slots (row ``i`` -> ``slots[i]``;
        trailing pad rows of the pane are simply not listed; the slots
        are distinct). In place. The slot keeps the prefill's LAST
        position logits — the next-item scores when a request carries no
        fresh suffix. On a mesh ``state`` is the whole pane, every row
        (``engine.full_pane``)."""
        idx = self._index(slots)
        n = len(slots)
        _tree_map(lambda pool, rows: pool.index_copy_(1, idx, rows[:, :n]),
                  self.caches, state["caches"])
        self.valid.index_copy_(0, idx, state["valid"][:n])
        self.next_pos.index_copy_(0, idx, state["next_pos"][:n])
        self.last_logits.index_copy_(0, idx, state["logits"][:n, -1])
        self.scatters += 1


# ----------------------------------------------------------------------
# The slot table
# ----------------------------------------------------------------------

class PagedStateCache:
    """LRU slot table over a :class:`DeviceStatePool` — the pooled
    counterpart of ``scheduler.PrefillStateCache``.

    Same key discipline (``(user, generation)``), same counter surface
    (hits/misses/evictions/invalidations/rekeys), same warm-handoff
    entry points (``rekey_generation`` / ``invalidate_except``) — but
    the values are **slot indices**, not host tensors, so every table
    operation is O(metadata): rekeying a generation renames dict keys
    and never moves a byte of device state, and invalidation just
    returns slots to the free list (the slots are overwritten on next
    admission, not zeroed).

    Eviction is **slot-pressure**: the pool is the byte budget (fixed
    slots × fixed slot size). When the free list is empty, allocation
    evicts the least-recently-used entry whose slot is not ``pinned`` —
    the pin set (slots referenced by the pane being assembled) makes
    mid-assembly eviction safe: a slot this pane reads or just wrote can
    never be reallocated out from under it. With ``n_slots >=
    max_batch`` (enforced by the pool) an allocation can always succeed.
    """

    def __init__(self, pool: DeviceStatePool):
        self.pool = pool
        self.budget = pool.n_slots      # warm() clamps to this, like the LRU
        self.byte_budget = pool.n_slots * pool.slot_nbytes
        self.shards = pool.data_shards
        self._entries: "OrderedDict[Tuple[int, int], int]" = OrderedDict()
        self._free: deque = deque(range(pool.n_slots))
        # host-side pending-inject sidecar for the O(delta) re-warm: the
        # deferred snapshot-delta tokens ride NEXT TO the slot table
        # (token lists are host metadata; the device slot itself is the
        # untouched old-generation prefill state). Keys mirror _entries
        # and are pruned wherever an entry dies, so a recycled slot can
        # never inherit a previous tenant's pending tokens.
        self._pending: Dict[Tuple[int, int], list] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        self.rekeys = 0
        # handoff window: retained old-generation keys of changed users
        # (retain_changed rekey) — first victims under slot pressure
        self._handoff_stale: set = set()
        self.stale_evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Tuple[int, int]) -> bool:
        return key in self._entries

    @property
    def bytes_per_shard(self) -> int:
        """Resident entry bytes: entries × slot size. The slot axis is
        replicated over the data axes, so per shard is the per-slot total
        (unlike the host LRU, whose pane rows shard over ``data``)."""
        return len(self._entries) * self.pool.slot_nbytes

    # ------------------------------------------------------------------
    def lookup(self, user: int, gen: int) -> Optional[int]:
        slot = self._entries.get((user, gen))
        if slot is None:
            self.misses += 1
            return None
        self._entries.move_to_end((user, gen))
        self.hits += 1
        return slot

    def _alloc(self, pinned: Set[int]) -> int:
        if self._free:
            return self._free.popleft()
        # rollover-aware victim order: a retained dual-generation entry
        # (changed user, old generation) evicts before any live entry —
        # LRU order among the stale, pin-aware like every eviction here.
        # _handoff_stale is empty outside the handoff window, so the
        # steady-state scan is the same single pass as before.
        victim = None
        if self._handoff_stale:
            victim = next((k for k, s in self._entries.items()
                           if k in self._handoff_stale and s not in pinned),
                          None)
        if victim is not None:
            self._handoff_stale.discard(victim)
            self.stale_evictions += 1
        else:
            victim = next((k for k, s in self._entries.items()
                           if s not in pinned), None)
        if victim is None:
            raise RuntimeError(
                f"no allocatable slot: all {self.pool.n_slots} slots are "
                f"pinned by the pane under assembly")
        slot = self._entries.pop(victim)
        self._pending.pop(victim, None)
        self.evictions += 1
        return slot

    def admit(self, user: int, gen: int, pinned: Set[int]) -> int:
        """Allocate a slot for ``(user, gen)`` (evicting an unpinned LRU
        entry under slot pressure) and insert it most-recently-used.
        The caller scatters the state into the returned slot."""
        old = self._entries.pop((user, gen), None)
        # a fresh admission overwrites the slot contents: any deferred
        # delta attached to the previous entry is superseded
        self._pending.pop((user, gen), None)
        slot = old if old is not None else self._alloc(pinned)
        self._entries[(user, gen)] = slot
        return slot

    def alloc_scratch(self, pinned: Set[int]) -> int:
        """A table-less slot for an ephemeral (uncacheable) pane row;
        must be returned via :meth:`free_scratch` when the pane retires."""
        return self._alloc(pinned)

    def free_scratch(self, slot: int) -> None:
        self._free.append(slot)

    # ------------------------------------------------------------------
    def invalidate_except(self, gen: int) -> int:
        """Purge every entry from a generation other than ``gen`` —
        table keys only; the slots go back on the free list untouched."""
        stale = [k for k in self._entries if k[1] != gen]
        for k in stale:
            self._free.append(self._entries.pop(k))
            self._pending.pop(k, None)
        self.invalidations += len(stale)
        self._handoff_stale = {k for k in self._handoff_stale
                               if k in self._entries}
        return len(stale)

    def rekey_generation(self, old_gen: int, new_gen: int, changed,
                         retain_changed: bool = False) -> Tuple[int, int]:
        """Warm handoff, slot-table edition: identical contract to
        ``PrefillStateCache.rekey_generation`` (same caller, same
        certification requirements, same ``retain_changed`` handoff-
        window semantics — see its docstring), but a rekey is a
        dict-key rename and an invalidation a free-list push. The
        device tensors are never read, moved, or zeroed; a retained
        entry keeps its slot out of the free list until evicted."""
        changed_set = {int(u) for u in np.asarray(changed).ravel()}
        live_new = {u for (u, g) in self._entries if g == new_gen}
        out: "OrderedDict[Tuple[int, int], int]" = OrderedDict()
        pend: Dict[Tuple[int, int], list] = {}
        stale: set = set()
        rekeyed = invalidated = 0
        for (u, g), slot in self._entries.items():
            p = self._pending.get((u, g))
            if g == new_gen:
                out[(u, g)] = slot
                if p is not None:
                    pend[(u, g)] = p
            elif g == old_gen and u not in live_new:
                if u not in changed_set:
                    out[(u, new_gen)] = slot
                    if p is not None:
                        pend[(u, new_gen)] = p
                    rekeyed += 1
                elif retain_changed:
                    out[(u, g)] = slot
                    if p is not None:
                        pend[(u, g)] = p
                    stale.add((u, g))
                else:
                    self._free.append(slot)
                    invalidated += 1
            else:
                self._free.append(slot)
                invalidated += 1
        self._entries = out
        self._pending = pend
        self._handoff_stale = stale
        self.rekeys += rekeyed
        self.invalidations += invalidated
        return rekeyed, invalidated

    def rekey_entry(self, user: int, old_gen, new_gen) -> bool:
        """Rename ONE entry ``(user, old_gen)`` -> ``(user, new_gen)``
        in place — the slot-table twin of
        ``PrefillStateCache.rekey_entry`` (same O(delta) re-warm caller,
        same certification contract). A dict-key rename: the device
        tensors never move. An existing ``new_gen`` entry for the user is
        replaced (its slot returns to the free list). Pending-inject
        tokens follow the renamed key. Returns False when no
        ``(user, old_gen)`` entry exists."""
        slot = self._entries.pop((user, old_gen), None)
        if slot is None:
            return False
        prev = self._entries.pop((user, new_gen), None)
        if prev is not None:
            self._free.append(prev)
            self._pending.pop((user, new_gen), None)
        self._entries[(user, new_gen)] = slot
        self._entries.move_to_end((user, new_gen))
        p = self._pending.pop((user, old_gen), None)
        if p is not None:
            self._pending[(user, new_gen)] = p
        self._handoff_stale.discard((user, old_gen))
        self.rekeys += 1
        return True

    def drop(self, user: int, gen) -> bool:
        """Invalidate one entry (serve-time fallback when a deferred
        delta no longer fits the inject budget). The slot returns to the
        free list untouched. Returns False when absent."""
        slot = self._entries.pop((user, gen), None)
        if slot is None:
            return False
        self._free.append(slot)
        self._pending.pop((user, gen), None)
        self._handoff_stale.discard((user, gen))
        self.invalidations += 1
        return True

    # ------------------------------------------------------------------
    # Backend-neutral delta-rewarm surface (mirrored by PrefillStateCache)
    # ------------------------------------------------------------------

    def has_entry(self, user: int, gen) -> bool:
        """Membership probe with NO side effects — no LRU bump, no
        hit/miss counters (``lookup`` counts; this peeks)."""
        return (user, gen) in self._entries

    def get_pending(self, user: int, gen) -> Optional[list]:
        """The entry's deferred-inject token list, or None."""
        return self._pending.get((user, gen))

    def set_pending(self, user: int, gen, tokens) -> None:
        """Attach (or, with an empty list, clear) the entry's deferred
        snapshot-delta tokens. Raises KeyError when the entry is absent
        — pending tokens without a state to defer onto are a bug."""
        if (user, gen) not in self._entries:
            raise KeyError(f"no entry ({user}, {gen}) to attach pending "
                           f"inject tokens to")
        if tokens:
            self._pending[(user, gen)] = list(tokens)
        else:
            self._pending.pop((user, gen), None)

    def stats(self) -> Dict[str, int]:
        return {"entries": len(self._entries), "hits": self.hits,
                "misses": self.misses, "evictions": self.evictions,
                "invalidations": self.invalidations,
                "rekeys": self.rekeys,
                "handoff_stale": len(self._handoff_stale),
                "stale_evictions": self.stale_evictions,
                "bytes_per_shard": self.bytes_per_shard,
                "shards": self.shards,
                "slots": self.pool.n_slots,
                "free_slots": len(self._free),
                "slot_bytes": self.pool.slot_nbytes}
