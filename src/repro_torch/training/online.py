"""Online incremental trainer and hot-swappable weight patches (the JAX
package's ``training/online.py``).

The trainer consumes the events appended to an :class:`EventLog` since
its cursor (``LogView.events_since``), builds next-item mini-batches from
the recent window of the users those events touched
(``LogView.materialize``, the feature plane's right-aligned read), steps
``make_train_step`` and emits versioned :class:`WeightPatch` objects:
full new values of the trainable leaves, keyed by ``keystr`` path, with a
``base_version`` guard so a patch is never applied out of order.

Patches carry full leaf values, not differences: the hot-swap contract is
that a swap serves bit for bit what a cold start from the patched weights
serves. A patch is the same bytes in either package (``to_bytes``), and
each package reads the other's.

The trainer holds its own copies of the parameters and an f32 master,
never the serving engine's tensors, and every step makes new tensors, so
a tree it handed out (``params``, a patch's leaves) does not change
afterwards. Its train step runs the model's plain path under autograd
(``training/train_loop.py``), so it launches no CUDA kernel.

An optional daemon worker (``start``) steps off the serving thread and
queues patches; the serving thread drains them with ``poll_patch``
(O(1); a worker exception is sticky and re-raised there). The synchronous
``step``/``make_patch`` pair is the deterministic path.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.event_log import EventLog
from repro_torch.core.pipeline import items_to_tokens
from repro_torch.models.common import flatten_with_keystr, resolve_device
from repro_torch.training import _msgpack
from repro_torch.training.checkpoint import _from_doc, _to_doc
from repro_torch.training.optimizer import init_opt_state
from repro_torch.training.train_loop import TrainConfig, make_train_step

__all__ = ["OnlineTrainer", "OnlineTrainerConfig", "WeightPatch",
           "flatten_with_keystr"]

DAY = 86400

_PATCH_CODEC_VERSION = 1


def _leaf_size(v) -> int:
    return int(v.numel()) if isinstance(v, torch.Tensor) \
        else int(np.asarray(v).size)


@dataclasses.dataclass(frozen=True)
class WeightPatch:
    """A versioned sparse weight update.

    ``leaves`` maps ``keystr`` leaf paths to full replacement values (CPU
    tensors or numpy arrays). ``base_version`` is the model version the
    patch applies on top of; installing it onto any other version is
    refused. ``version`` (``base_version + 1`` in a trainer's stream) is
    the model version the install produces.
    """
    version: int
    base_version: int
    step: int                       # trainer step count at emission
    leaves: Dict[str, Any]          # keystr path -> tensor or ndarray
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def n_leaves(self) -> int:
        return len(self.leaves)

    @property
    def n_params(self) -> int:
        return sum(_leaf_size(v) for v in self.leaves.values())

    def to_bytes(self) -> bytes:
        """The patch in the JAX package's msgpack wire format."""
        doc = {"codec": _PATCH_CODEC_VERSION, "version": self.version,
               "base_version": self.base_version, "step": self.step,
               "metadata": self.metadata,
               "leaves": _to_doc(dict(self.leaves))}
        return _msgpack.packb(doc)

    @staticmethod
    def from_bytes(data: bytes) -> "WeightPatch":
        """A patch from either package's ``to_bytes``; leaves come back as
        CPU tensors. Another codec version raises ``ValueError``."""
        doc = _msgpack.unpackb(data)
        if not isinstance(doc, dict) \
                or doc.get("codec") != _PATCH_CODEC_VERSION:
            codec = doc.get("codec") if isinstance(doc, dict) else None
            raise ValueError(f"unsupported patch codec {codec!r}")
        return WeightPatch(
            version=int(doc["version"]),
            base_version=int(doc["base_version"]),
            step=int(doc["step"]),
            leaves=_from_doc(doc["leaves"]),
            metadata=doc.get("metadata", {}))


@dataclasses.dataclass(frozen=True)
class OnlineTrainerConfig:
    batch_size: int = 8
    seq_len: int = 32               # tokens per example (window read k-1)
    window: int = 30 * DAY          # event-time lookback per example
    min_new_events: int = 1         # suffix size required to run a step
    steps_per_patch: int = 1        # train steps bundled into one patch
    # keystr substrings selecting the trainable (and therefore patched)
    # leaf subset; None trains and ships every leaf. This is what makes a
    # patch a delta, e.g. ("embed",) ships the item-embedding table alone
    trainable: Optional[tuple] = None
    # background worker cadence (seconds between step attempts)
    interval_s: float = 0.05


def _rebuild(tree, flat: Dict[str, Any], prefix: str = ""):
    """``tree``'s structure with the leaves of ``flat`` (keyed by keystr)."""
    return {k: _rebuild(v, flat, f"{prefix}[{k!r}]") if isinstance(v, dict)
            else flat[f"{prefix}[{k!r}]"] for k, v in tree.items()}


class OnlineTrainer:
    """Incremental trainer over a live :class:`EventLog`.

    Synchronous API (deterministic): ``step()`` consumes the appended-event
    suffix and runs one train step (returns the metrics, or ``None`` if
    there was too little new data); ``make_patch()`` emits the next
    :class:`WeightPatch`.

    Background API: ``start()`` spawns a daemon worker that steps and
    queues a patch every ``steps_per_patch`` successful steps; the serving
    thread drains them with ``poll_patch()``. Worker exceptions are sticky
    and re-raised from ``poll_patch()``/``stop()``.

    ``params`` is copied to ``device`` (the CUDA device unless
    ``device="cpu"``); the trainer never holds the caller's tensors.
    """

    def __init__(self, model_cfg: ModelConfig, params, log: EventLog, *,
                 cfg: OnlineTrainerConfig = OnlineTrainerConfig(),
                 train_cfg: Optional[TrainConfig] = None,
                 base_version: int = 0,
                 step_hook: Optional[Callable[[], None]] = None,
                 device="cuda"):
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.log = log
        self.device = resolve_device(device)
        params = _rebuild(params, {
            k: v.detach().to(self.device, copy=True)
            for k, v in flatten_with_keystr(params)})
        if train_cfg is None:
            # the emitted weights must be dtype-identical to what the
            # serving engine holds: bitwise swap equivalence starts here
            train_cfg = TrainConfig(
                param_dtype=flatten_with_keystr(params)[0][1].dtype)
        self.train_cfg = train_cfg
        self._step_fn = make_train_step(model_cfg, train_cfg)
        self._params = params
        self._opt = init_opt_state(params)
        self._version = int(base_version)
        self._cursor = 0            # log position trained through
        self.missed_events = 0      # consumed-range events the tiered
        #                             log no longer held (see step())
        self._rr = 0                # round-robin user cursor
        self._steps = 0
        self._steps_at_patch = 0
        self.history: List[Dict[str, float]] = []
        self.step_time_s = 0.0
        if cfg.trainable is None:
            self._trainset = None
        else:
            self._trainset = {
                k for k, _ in flatten_with_keystr(params)
                if any(sub in k for sub in cfg.trainable)}
            if not self._trainset:
                raise ValueError(
                    f"trainable filter {cfg.trainable!r} matches no "
                    f"param leaf")
        # background worker plumbing
        self._step_hook = step_hook
        self._patch_q: "collections.deque[WeightPatch]" = \
            collections.deque()
        self._qlock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    @property
    def params(self):
        """Current full weights (what a cold engine started 'from the
        patched weights' is built with)."""
        return self._params

    @property
    def version(self) -> int:
        """Model version of the last emitted patch (``base_version`` until
        the first ``make_patch``)."""
        return self._version

    @property
    def steps(self) -> int:
        return self._steps

    @property
    def cursor(self) -> int:
        return self._cursor

    # ------------------------------------------------------------------
    # synchronous path
    # ------------------------------------------------------------------
    def step(self) -> Optional[Dict[str, float]]:
        """Consume the appended-event suffix and run one train step.

        Returns the step metrics (floats), or ``None`` when fewer than
        ``min_new_events`` events arrived since the last consumed position
        (the cursor does not move) or the batch had no scorable transition
        (the cursor moves: the data was consumed, just untrainable)."""
        t0 = time.perf_counter()
        view = self.log.view()
        # gate on appended POSITIONS, not retained rows: a tiered log may
        # have lost part of the suffix, and the hole must still be consumed
        if view.n_events - self._cursor < max(self.cfg.min_new_events, 1):
            return None
        users, _items, ts = view.events_since(self._cursor)
        # positions in [cursor, n_events) the view no longer holds were
        # dropped, trimmed or evicted before this step consumed them
        self.missed_events += \
            int(view.n_events - self._cursor) - len(users)
        if len(users) == 0:
            self._cursor = view.n_events
            return None
        batch = self._build_batch(view, users, ts)
        self._cursor = view.n_events
        if batch is None:
            return None
        params, opt, metrics = self._step_fn(self._params, self._opt, batch)
        if self._trainset is not None:
            params = self._merge_frozen(params, self._params)
            opt = opt._replace(
                master=self._merge_frozen(opt.master, self._opt.master),
                m=self._merge_frozen(opt.m, self._opt.m),
                v=self._merge_frozen(opt.v, self._opt.v))
        self._params, self._opt = params, opt
        self._steps += 1
        out = {k: float(v) for k, v in metrics.items()}
        self.history.append(out)
        self.step_time_s += time.perf_counter() - t0
        return out

    def _build_batch(self, view, users: np.ndarray, ts: np.ndarray,
                     ) -> Optional[Dict[str, np.ndarray]]:
        """Next-item-prediction batch from the recent window of the users
        the new events touched. Deterministic: unique users in sorted
        order, rotated by a round-robin cursor so repeated steps over a
        hot set cycle through it."""
        c = self.cfg
        uniq = np.unique(users)
        if len(uniq) > c.batch_size:
            r = self._rr % len(uniq)
            uniq = np.concatenate([uniq[r:], uniq[:r]])[:c.batch_size]
            self._rr += c.batch_size
        hi = int(ts.max()) + 1
        items, _t, valid = view.materialize(
            uniq, hi - c.window, hi, c.seq_len + 1)
        # train in the serving token space (item+1, pad->0): the weights
        # this trainer ships score injected histories that went through
        # the same items_to_tokens mapping
        toks = items_to_tokens(items, valid)
        tokens = toks[:, :-1].astype(np.int32)
        labels = toks[:, 1:].astype(np.int32)
        # position j scores label j+1 given the prefix through j; rows are
        # right-aligned, so both slots valid <=> the token slot is valid
        mask = (valid[:, :-1] * valid[:, 1:]).astype(np.int32)
        if int(mask.sum()) == 0:
            return None
        return {"tokens": tokens, "labels": labels,
                "valid": valid[:, :-1].astype(np.int32),
                "loss_mask": mask}

    def _merge_frozen(self, new_tree, old_tree):
        """The old leaf at every non-trainable path.

        Masking gradients is not enough (AdamW's decoupled weight decay
        moves matrix leaves even at zero gradient), so frozen leaves are
        frozen by construction: the post-step tree keeps the pre-step
        tensors."""
        old = dict(flatten_with_keystr(old_tree))
        return _rebuild(new_tree, {
            k: n if k in self._trainset else old[k]
            for k, n in flatten_with_keystr(new_tree)})

    def make_patch(self, metadata: Optional[dict] = None) -> WeightPatch:
        """Emit the next versioned patch: CPU copies of the current values
        of every trainable leaf, guarded by the current base version."""
        leaves = {k: v.detach().to("cpu", copy=True)
                  for k, v in flatten_with_keystr(self._params)
                  if self._trainset is None or k in self._trainset}
        patch = WeightPatch(
            version=self._version + 1, base_version=self._version,
            step=self._steps, leaves=leaves,
            metadata=dict(metadata or {}, steps=self._steps))
        self._version += 1
        self._steps_at_patch = self._steps
        return patch

    # ------------------------------------------------------------------
    # background worker
    # ------------------------------------------------------------------
    def start(self) -> "OnlineTrainer":
        """Spawn the daemon worker. Idempotent while running."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._work, name="online-trainer", daemon=True)
        self._thread.start()
        return self

    def _work(self) -> None:
        try:
            while not self._stop.is_set():
                stepped = self.step() is not None
                if stepped and (self._steps - self._steps_at_patch
                                >= self.cfg.steps_per_patch):
                    patch = self.make_patch()
                    with self._qlock:
                        self._patch_q.append(patch)
                if self._step_hook is not None:
                    self._step_hook()
                if not stepped:
                    self._stop.wait(self.cfg.interval_s)
        except BaseException as e:    # sticky: re-raised from poll_patch
            self._error = e

    def poll_patch(self) -> Optional[WeightPatch]:
        """Next pending patch from the worker, or ``None``. O(1); never
        blocks. Re-raises a worker exception, stickily."""
        if self._error is not None:
            raise RuntimeError("online trainer worker failed") \
                from self._error
        with self._qlock:
            return self._patch_q.popleft() if self._patch_q else None

    def stop(self, timeout: Optional[float] = 10.0) -> None:
        """Signal the worker to exit and join it."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
        if self._error is not None:
            raise RuntimeError("online trainer worker failed") \
                from self._error
