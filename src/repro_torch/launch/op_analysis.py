"""The cost of one step, from one run of it: the port's counterpart of the
JAX package's ``launch/hlo_analysis.py``.

The JAX dry run compiles a step and parses XLA's optimized HLO. Eager
torch has no HLO to read, so :func:`analyze` runs the step once, as a
user would call it, and watches what it dispatches. On meta tensors (the
dry run, ``launch/dryrun.py``) that costs shapes only and allocates
nothing. It sums:

* **FLOPs**: ``torch.utils.flop_counter.FlopCounterMode``, whose matrix
  products count as the dots that ``hlo_analysis`` counts; a kernel
  wrapper's meta route adds the products of its plain version
  (:func:`kernel_scope`), which is what XLA's dots give the JAX
  reference path.
* **bytes accessed**: the operand and result bytes of every aten op that
  is not a view or an empty allocation (of an indexed write in place, such as a ring-cache
  update, the rows written and not the whole destination), and each
  kernel's inputs and outputs. Nothing is fused here, so this is an
  upper bound on the step's traffic; XLA's count is over its fusions.
* **peak bytes**: the bytes of the untyped storages that the step
  creates and that are alive at once, each freed through
  ``weakref.finalize`` when its last tensor dies. The arguments, and any
  tensor from before the step that it writes in place or views, are not
  among them; a step's peak on the card is the arguments' bytes plus
  this.
* **collectives**: what ``sharding/local.py``'s helpers report, one
  ``(kind, axes, group size, result bytes)`` record a call, on an
  abstract ``MeshShape`` as on a real ``DeviceMesh``; wire bytes by the
  ring factors of ``launch/roofline.py``.

``HloCost``'s ``loop_trips`` and ``unknown_trip_loops`` have no
counterpart: eager torch has no while loops, and every op is dispatched
each time it runs, so nothing needs a trip count.

With no analysis active, :func:`record_collective` and
:func:`kernel_scope` cost one context-variable read and record nothing.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import weakref
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

# the ring model's wire bytes a device, from a collective's result bytes
# and its group size g (the JAX package's ``launch/roofline.py``)
RING_FACTORS = {
    "all-gather": lambda g: (g - 1) / g,
    "reduce-scatter": lambda g: float(g - 1),
    "all-reduce": lambda g: 2 * (g - 1) / g,
    "all-to-all": lambda g: (g - 1) / g,
    "collective-permute": lambda g: 1.0,
}

TOP = 20  # entries kept in ``OpCost.top_bytes``

# ops that allocate and touch no byte
ALLOCATIONS = frozenset(("empty", "empty_like", "empty_strided",
                         "new_empty", "new_empty_strided"))
# ops that write rows of their first operand in place: their traffic is
# the other operands, read and written, not the whole destination
INDEXED_WRITES = frozenset(("index_put_", "_index_put_impl_", "scatter_",
                            "scatter_add_", "index_copy_", "index_add_"))


def wire_bytes(kind: str, out_bytes: float, group: int) -> float:
    """Bytes a device puts on the wire for one collective."""
    return out_bytes * RING_FACTORS[kind](group)


@dataclasses.dataclass
class OpCost:
    """One step's cost. The fields that ``HloCost`` also has mean what
    they mean there: ``collective_bytes`` is wire bytes by kind, and
    ``top_bytes`` the largest traffic, here summed over the calls of one
    (op, result type): ``(bytes, op name, result type, calls)``."""
    flops: float = 0.0
    bytes_accessed: float = 0.0
    wire_bytes: float = 0.0
    collective_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    top_bytes: List[Tuple[float, str, str, int]] = dataclasses.field(
        default_factory=list)
    peak_bytes: int = 0        # storages the step created, alive at once
    output_bytes: int = 0      # the result's storages
    # (kind, axes, group size, result bytes), one a collective call
    collectives: List[Tuple[str, Tuple[str, ...], int, int]] = \
        dataclasses.field(default_factory=list)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _type_str(t: torch.Tensor) -> str:
    return f"{str(t.dtype).replace('torch.', '')}{list(t.shape)}"


class _Analysis:
    """What one :func:`analyze` call gathers."""

    def __init__(self):
        self.cost = OpCost()
        self.live = 0
        self.suspended = False
        self.seen: Dict[int, int] = {}   # storage _cdata -> bytes
        self.traffic: Dict[Tuple[str, str], List] = {}

    def adopt(self, storage, new: bool = True) -> None:
        """Track a storage until it is freed: counted if the step ``new``ly
        created it, else (an argument, or a tensor from before the step
        that it writes or views) known and not counted."""
        key = storage._cdata
        if key in self.seen:
            return
        n = storage.nbytes() if new else 0
        self.seen[key] = n
        self.live += n
        self.cost.peak_bytes = max(self.cost.peak_bytes, self.live)
        weakref.finalize(storage, self._free, key)

    def _free(self, key: int) -> None:
        n = self.seen.pop(key, None)
        if n is not None:
            self.live -= n

    def traffic_of(self, name: str, result, nbytes: int) -> None:
        self.cost.bytes_accessed += nbytes
        key = (name, result)
        entry = self.traffic.setdefault(key, [0, 0])
        entry[0] += nbytes
        entry[1] += 1


_ACTIVE: contextvars.ContextVar[Optional[_Analysis]] = \
    contextvars.ContextVar("op_analysis", default=None)


class _Ledger(TorchDispatchMode):
    """Bytes accessed and live storages of every op the step dispatches."""

    def __init__(self, analysis: _Analysis):
        super().__init__()
        self.analysis = analysis

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        a = self.analysis
        if a.suspended:
            return out
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        in_keys = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            storage = t.untyped_storage()
            a.adopt(storage, new=storage._cdata not in in_keys)
        name = func.overloadpacket.__name__
        if not func.is_view and name not in ALLOCATIONS:
            if name in INDEXED_WRITES:
                # reads and writes the indexed rows, not the destination
                nbytes = 2 * sum(_nbytes(t) for t in ins[1:])
            else:
                nbytes = sum(_nbytes(t) for t in ins + outs)
            a.traffic_of(name, _type_str(outs[0]) if outs else "", nbytes)
        return out


def storage_bytes(tree) -> Dict[int, int]:
    """{storage key: bytes} of the distinct storages that ``tree``'s
    tensors hold."""
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor)}


def analyze(step, args) -> Tuple[object, OpCost]:
    """``(step(*args), its OpCost)``: one run of ``step`` on ``args``
    under the counters of the module docstring. Meant for meta tensors
    (the dry run); on real ones the step runs for real, as the CPU tests
    and ``tools/torch_slot_pool_check.py`` run it."""
    analysis = _Analysis()
    # the arguments' storages are there before the step and are not its
    # own: an in-place update of one allocates nothing
    for t in tree_leaves(args):
        if isinstance(t, torch.Tensor):
            analysis.adopt(t.untyped_storage(), new=False)
    token = _ACTIVE.set(analysis)
    try:
        with FlopCounterMode(display=False) as flops, _Ledger(analysis):
            out = step(*args)
    finally:
        _ACTIVE.reset(token)
    cost = analysis.cost
    cost.flops = float(flops.get_total_flops())
    cost.output_bytes = sum(storage_bytes(out).values())
    cost.top_bytes = sorted(
        ((float(b), op, ty, calls)
         for (op, ty), (b, calls) in analysis.traffic.items()),
        key=lambda e: -e[0])[:TOP]
    return out, cost


def record_collective(kind: str, axes, group: int, result) -> None:
    """Report one collective call of ``group`` ranks over ``axes`` whose
    result is the tensor (or shape-equal meta tensor) ``result``."""
    a = _ACTIVE.get()
    if a is None:
        return
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    nbytes = _nbytes(result)
    c = a.cost
    c.collectives.append((kind, axes, group, nbytes))
    c.collective_counts[kind] = c.collective_counts.get(kind, 0) + 1
    w = wire_bytes(kind, nbytes, group)
    c.collective_bytes[kind] = c.collective_bytes.get(kind, 0.0) + w
    c.wire_bytes += w


@contextlib.contextmanager
def kernel_scope(name: str, inputs, outputs):
    """Around a kernel wrapper's meta route running its plain version on
    the meta inputs: the plain version's products count as the kernel's
    FLOPs, but none of its ops' bytes or storages do. The kernel's own
    traffic is its ``inputs`` and ``outputs`` (allocated by the caller
    before this scope, so that they count as live). Yields whether an
    analysis is active; the caller runs the plain version only if so."""
    a = _ACTIVE.get()
    if a is None:
        yield False
        return
    nbytes = sum(_nbytes(t) for t in inputs if t is not None) \
        + sum(_nbytes(t) for t in outputs)
    a.traffic_of(name, _type_str(outputs[0]), nbytes)
    a.suspended = True
    try:
        yield True
    finally:
        a.suspended = False
