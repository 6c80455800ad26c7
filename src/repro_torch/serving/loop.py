"""Legacy wave-oriented serving API — a thin wrapper over the Gateway.

.. deprecated::
    ``InjectionServer.serve(users, now)`` predates the request-level
    serving API. The system's one serving facade is now the
    :class:`~repro_torch.serving.scheduler.Gateway` (typed
    ``Request``/``Response`` lifecycle, micro-batching scheduler,
    per-request policy/slate_len/deadline, unified event ingestion and
    telemetry — see ``serving/api.py`` and ``serving/scheduler.py``). A wave is just a
    degenerate request trace — every arrival at the same instant, all on
    the gateway defaults:

        serve(users, now)  ==  submit_many([Request(u, now) for u in users])
                               + flush(now)

    which is literally how this wrapper is implemented, so it serves
    **bitwise-identical** slates/scores to the pre-Gateway wave loop
    (same pane formation, same cache-aware hit/miss partitioning, same
    engine call sequence) — verified by tests/test_torch_serving_api.py.
    ``serve()`` emits a DeprecationWarning; new code should construct a
    Gateway directly.

The serving design itself — the prefill-state cache keyed
``(user, snapshot generation)``, the cache-key invariant, the
warm-handoff generation rollover, cache-aware pane formation,
host-resident LRU entries — lives with the scheduler; see the module
docstring of ``serving/scheduler.py``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Sequence

import numpy as np

from repro_torch.core.injection import FeatureInjector
from repro_torch.serving.api import GatewayStats, Request
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.scheduler import (  # noqa: F401  (re-exported:
    Gateway, PrefillStateCache, ServerConfig)  # the pre-Gateway public
#                                                surface lived here


@dataclasses.dataclass
class ServeResult:
    scores: np.ndarray            # (N, vocab_padded) next-item logits
    slate: np.ndarray             # (N, slate_len) greedy token ids
    cache_hits: int               # rows served from the prefill-state cache
    cache_misses: int             # rows that paid a prefill this request


class InjectionServer:
    """Back-compat wave API: the full request path, one call —
    ``serve(users, now)``. Deprecated; thin shim over :class:`Gateway`.

    Everything stateful (cache, counters, clock) belongs to the wrapped
    gateway, exposed read-through so existing callers and tests keep
    working; ``warm``/``stats`` delegate directly.
    """

    def __init__(self, engine: ServingEngine, injector: FeatureInjector,
                 cfg: ServerConfig = ServerConfig()):
        self.gateway = Gateway(engine, injector, cfg)

    # -- read-through compatibility surface ----------------------------
    @property
    def engine(self) -> ServingEngine:
        return self.gateway.engine

    @property
    def injector(self) -> FeatureInjector:
        return self.gateway.injector

    @property
    def cfg(self) -> ServerConfig:
        return self.gateway.cfg

    @property
    def cache(self) -> PrefillStateCache:
        return self.gateway.cache

    @property
    def requests(self) -> int:
        return self.gateway.requests

    @property
    def panes(self) -> int:
        return self.gateway.panes

    @property
    def prefill_calls(self) -> int:
        return self.gateway.prefill_calls

    @property
    def inject_calls(self) -> int:
        return self.gateway.inject_calls

    @property
    def decode_steps(self) -> int:
        return self.gateway.decode_steps

    # ------------------------------------------------------------------
    def warm(self, users: Sequence[int], now: int) -> int:
        """Daily-job cache precompute; see :meth:`Gateway.warm`."""
        return self.gateway.warm(users, now)

    def serve(self, users: Sequence[int], now: int) -> ServeResult:
        """Serve one pre-grouped wave. Deprecated: submit Requests to
        the Gateway instead (this shim is exactly ``submit_many`` +
        ``flush`` on default-policy requests)."""
        warnings.warn(
            "InjectionServer.serve(users, now) is deprecated; use "
            "Gateway.submit/submit_many with typed Requests "
            "(repro_torch.serving.scheduler.Gateway)",
            DeprecationWarning, stacklevel=2)
        gw = self.gateway
        # Legacy semantics: the wave is served AT the call's ``now``,
        # even if an earlier call used a later time — the pre-Gateway
        # loop read features/generation at whatever ``now`` it was
        # handed. The request API's clock is deliberately monotonic, so
        # the shim rewinds it explicitly rather than inheriting
        # "serve at max(now, previous now)" behavior the legacy loop
        # never had.
        gw._clock = int(now)
        users = np.asarray(users, np.int64).ravel()
        if len(users) == 0:
            gw.tick(now)  # the legacy loop still synced the snapshot
            return ServeResult(
                scores=np.zeros((0, gw.engine.cfg.vocab_padded), np.float32),
                slate=np.zeros((0, gw.cfg.slate_len), np.int32),
                cache_hits=0, cache_misses=0)
        hits0, miss0 = gw.cache.hits, gw.cache.misses
        tickets = gw.submit_many(
            [Request(user=int(u), now=int(now)) for u in users])
        gw.flush(now)
        return ServeResult(
            scores=np.stack([t.response.scores for t in tickets]),
            slate=np.stack([t.response.slate for t in tickets]),
            cache_hits=gw.cache.hits - hits0,
            cache_misses=gw.cache.misses - miss0)

    # ------------------------------------------------------------------
    def stats(self) -> GatewayStats:
        return self.gateway.stats()
