"""Typed per-request serving API — the unit of the paper's deployment.

The paper's surface is per-request: a user arrives, their fresh suffix
is injected, a slate is served. This module is the request-level
contract the :class:`~repro_torch.serving.scheduler.Gateway` serves:

    Request   — one arrival: (user, now) plus optional per-request
                policy (the A/B arm), slate_len, deadline, and tag.
                Frozen; validated at construction so a malformed request
                fails at the call site, not as a shape error in the engine.
    Response  — the served slate + next-item scores + structured
                telemetry for that request.
    Ticket    — the handle ``submit`` returns; ``.response`` fills in
                when the scheduler flushes the pane the request rode in.
    Event     — one feedback event (user watched item at ts); the
                ingestion type ``Gateway.observe`` and the platform
                observe hooks share.

Per-request **policy** is what makes the A/B split expressible at
request granularity (the wave API baked one policy into the server):
rows with different arms coexist in one fixed-shape pane and are
resolved at feature-assembly time. ``hash_arm`` is the deterministic
user->arm assignment an experiment uses to label requests.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

POLICIES = ("batch", "inject", "fresh", "decay")


# ----------------------------------------------------------------------
# Events (ingestion side of the facade)
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Event:
    """One feedback event: ``user`` watched ``item`` at ``ts``."""
    user: int
    item: int
    ts: int


def as_event(ev) -> Event:
    """Coerce an event-like value — an :class:`Event`, a ``(user, item,
    ts)`` tuple, or any object with ``.user/.item/.ts`` attributes (the
    simulator's event records) — into an :class:`Event`."""
    if isinstance(ev, Event):
        return ev
    if isinstance(ev, (tuple, list)) and len(ev) == 3:
        return Event(int(ev[0]), int(ev[1]), int(ev[2]))
    try:
        return Event(int(ev.user), int(ev.item), int(ev.ts))
    except AttributeError:
        raise TypeError(
            f"cannot interpret {ev!r} as an event; pass an Event, a "
            f"(user, item, ts) tuple, or an object with .user/.item/.ts")


# ----------------------------------------------------------------------
# Request / Response
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request, validated at construction.

    ``policy``/``slate_len`` default to ``None`` = "use the gateway's
    configured default" — a request only carries what it overrides.
    ``deadline`` is an absolute time: the scheduler must flush the
    request's pane (padding it if short) once its clock reaches it.
    ``tag`` is free-form caller context (experiment arm label, trace
    id); it rides through to the telemetry untouched.
    """
    user: int
    now: int
    policy: Optional[str] = None
    slate_len: Optional[int] = None
    deadline: Optional[int] = None
    tag: Optional[str] = None

    def __post_init__(self):
        if self.user < 0:
            raise ValueError(f"user must be >= 0, got {self.user}")
        if self.policy is not None and self.policy not in POLICIES:
            raise ValueError(
                f"unknown policy {self.policy!r}; expected one of "
                f"{POLICIES} (or None for the gateway default)")
        if self.slate_len is not None and self.slate_len < 1:
            raise ValueError(
                f"slate_len must be >= 1, got {self.slate_len}")
        if self.deadline is not None and self.deadline < self.now:
            raise ValueError(
                f"deadline ({self.deadline}) must be >= the request's "
                f"arrival time now ({self.now})")


@dataclasses.dataclass(frozen=True)
class RequestTelemetry:
    """Structured per-request observability, attached to every Response.

    ``queue_delay`` is in request-clock units (``served_at - now``,
    clamped at 0): how long the request waited for its pane to fill or
    its deadline to fire. The clamp matters only under the deprecated
    legacy shim, whose non-monotonic replay rewinds the gateway clock —
    a request pending from a later wave would otherwise record a
    negative delay and pollute the ``stats()`` percentiles. ``path``
    says what the request actually paid:

      * ``"prefill"`` — the row paid a batch-history prefill this
        request (cache miss, uncacheable policy, or caching disabled);
      * ``"inject"``  — served from a cached prefill state with a
        non-empty fresh suffix injected (the paper's hot path);
      * ``"cached"``  — served from a cached prefill state with no
        fresh events pending (pure cache read + decode);
      * ``"decay"``   — served model-free: the slate was ranked by
        exponentially time-decayed event scores computed from the
        user's cutoff-exact features (policy ``"decay"``); no engine
        call, no cache entry;
      * ``"shed"``    — never served: the deadline-aware load-shedder
        rejected the request because its projected completion time
        exceeded its deadline (``Response.shed`` is True, the slate is
        empty, ``pane_id`` is -1). Shed rows are counted in
        ``GatewayStats.shed``, not in ``paths``.
    """
    request_id: int
    user: int
    policy: str
    slate_len: int
    pane_id: int
    queue_delay: int
    cache_hit: bool
    path: str
    generation: int
    submitted_at: int
    served_at: int
    tag: Optional[str] = None
    model_version: int = 0    # weight version the pane was scored with


@dataclasses.dataclass
class Response:
    """What one request gets back: the slate, the scores it was ranked
    from, and the request's telemetry record.

    ``shed=True`` is the typed rejection marker of deadline-aware load
    shedding (``ServerConfig.shed_policy``): the scheduler projected the
    request would complete past its deadline and refused to serve it
    late. A shed response carries an **empty** slate/scores and a
    telemetry record with ``path="shed"`` — callers must check ``shed``
    before reading the slate."""
    slate: np.ndarray          # (slate_len,) int32 greedy distinct items
    scores: np.ndarray         # (vocab_padded,) float32 next-item logits
    telemetry: RequestTelemetry
    shed: bool = False         # True -> rejected by the load-shedder


class Ticket:
    """Handle for a submitted request; ``response`` fills at flush (or
    immediately with a shed marker when the load-shedder rejects).
    ``completed_wall`` is the ``time.perf_counter()`` stamp taken when
    the response filled — ``completed_wall - submitted_wall`` is the
    request's wall-clock residence time, the number the load generator's
    per-path serve-latency SLOs gate on."""

    __slots__ = ("request", "request_id", "response", "submitted_wall",
                 "completed_wall")

    def __init__(self, request: Request, request_id: int,
                 submitted_wall: float = 0.0):
        self.request = request
        self.request_id = request_id
        self.response: Optional[Response] = None
        self.submitted_wall = submitted_wall
        self.completed_wall: float = 0.0

    @property
    def done(self) -> bool:
        return self.response is not None

    def __repr__(self) -> str:
        state = "done" if self.done else "pending"
        return (f"Ticket(id={self.request_id}, user={self.request.user}, "
                f"{state})")


# ----------------------------------------------------------------------
# Typed gateway telemetry aggregates
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RolloverStats:
    """Generation-rollover telemetry: warm-handoff and incremental-build
    counters (see scheduler docstring, "Generation rollover")."""
    rollovers: int            # generation rolls the gateway handed across
    rekeyed: int              # entries renamed to the new generation
    invalidated: int          # entries purged (changed users/stale gens)
    retained: int             # changed-user old-gen entries kept at handoff
    rebuilt: int              # users re-prefilled by warm_step
    delta_rewarms: int        # entries rebuilt via O(delta) deferred inject
    build_steps: int          # incremental snapshot-build slices run
    build_time_s: float       # wall time spent in completed builds
    pending_build_users: int  # users left in the in-flight build
    pending_rewarm: int       # invalidated users still queued for re-warm
    # worst single clock-call slice spent advancing the snapshot job
    # (wall time, so excluded from == — the sharded-equivalence check
    # compares stats across gateways whose wall clocks differ)
    build_slice_max_s: float = dataclasses.field(compare=False,
                                                 default=0.0)

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def __getitem__(self, key: str) -> Any:
        # migration shim for dict-era callers (stats()["rollover"]["rekeyed"])
        return getattr(self, key)


@dataclasses.dataclass(frozen=True)
class GatewayStats:
    """The typed ``Gateway.stats()`` snapshot.

    Frozen and directly comparable (the sharded-equivalence check
    asserts single-device == mesh stats by ``==``). ``paths`` and
    ``queue_delay`` stay plain dicts — they are aggregate views the
    bench suites serialize as-is. ``__getitem__`` keeps dict-era
    ``stats()["key"]`` callers working; new code should use attributes,
    and anything that needs JSON should call :meth:`as_dict`.
    """
    requests: int
    panes: int
    pending: int              # queued, not yet served
    completed: int            # served, not yet claimed by poll()/drain()
    prefill_calls: int
    inject_calls: int
    decode_steps: int
    deadline_flushes: int
    shed: int                 # requests rejected by the load-shedder
    deadline_misses: int      # requests SERVED past their deadline
    paths: Dict[str, int]     # "prefill"/"inject"/"cached"/"decay" rows
    queue_delay: Dict[str, float]  # window/p50/p99/max over recent requests
    rollover: RolloverStats
    cache: Dict[str, int]     # PrefillStateCache / PagedStateCache counters
    # tiered EventLog ingest counters (EventLog.ingest_stats()):
    # appended/events_hot/events_warm/bytes_hot/bytes_warm/demoted/
    # dropped_late/trimmed/evicted/compactions/segments/hot_overflow
    ingest: Dict[str, int] = dataclasses.field(default_factory=dict)
    model_version: int = 0    # current hot-swapped weight version
    patches_applied: int = 0  # delta weight patches installed so far
    # worst single install_patch() stall observed on the serving thread
    # (wall-clock ms, so excluded from == like build_slice_max_s)
    patch_install_max_ms: float = dataclasses.field(compare=False,
                                                    default=0.0)

    def as_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)  # recurses into RolloverStats

    def __getitem__(self, key: str) -> Any:
        return getattr(self, key)


# ----------------------------------------------------------------------
# Per-request A/B arm assignment
# ----------------------------------------------------------------------

def hash_arm(user: int, arms: Sequence[str] = ("control", "treatment"),
             salt: int = 0) -> str:
    """Deterministic user -> arm assignment for request-level A/B.

    Stable across processes (md5, not ``hash()``), uniform over arms,
    and re-randomizable per experiment via ``salt``. The same user is
    always in the same arm within one salt — the unit of randomization
    is the user, as in the paper's experiment — but assignment happens
    per *request*, which is what lets arms share one serving fleet
    (mixed-policy panes) instead of one server per arm.
    """
    if not arms:
        raise ValueError("arms must be non-empty")
    h = hashlib.md5(f"{salt}:{int(user)}".encode()).hexdigest()
    return arms[int(h, 16) % len(arms)]


def assign_arms(users, arms: Sequence[str] = ("control", "treatment"),
                salt: int = 0) -> Tuple[str, ...]:
    """Vector form of :func:`hash_arm` over a user array."""
    return tuple(hash_arm(int(u), arms, salt) for u in np.asarray(users).ravel())
