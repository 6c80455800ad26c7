"""Public serving surface.

The one serving facade is the :class:`Gateway` (submit/poll streaming
lifecycle over typed Requests) over the token-level
:class:`ServingEngine`; :class:`InjectionServer` is the deprecated
wave-era shim kept for bitwise-compat callers.
"""
from repro_torch.serving.api import (  # noqa: F401
    Event, GatewayStats, Request, RequestTelemetry, Response,
    RolloverStats, Ticket, as_event, assign_arms, hash_arm)
from repro_torch.serving.engine import (  # noqa: F401
    ServingConfig, ServingEngine, make_serve_step)
from repro_torch.serving.scheduler import (  # noqa: F401
    Gateway, PrefillStateCache, ServerConfig)
from repro_torch.serving.pool import (  # noqa: F401
    DeviceStatePool, PagedStateCache)
from repro_torch.serving.loop import (  # noqa: F401
    InjectionServer, ServeResult)
from repro_torch.serving.loadgen import (  # noqa: F401
    SCENARIO_NAMES, ScenarioResult, ScenarioSpec, SLOContract, Trace,
    evaluate_slo, get_scenario, make_trace, run_scenario)

__all__ = [
    # request-level API (serving/api.py)
    "Event", "Request", "Response", "RequestTelemetry", "Ticket",
    "GatewayStats", "RolloverStats", "as_event", "hash_arm", "assign_arms",
    # engine (serving/engine.py)
    "ServingConfig", "ServingEngine", "make_serve_step",
    # scheduler / facade (serving/scheduler.py)
    "Gateway", "ServerConfig", "PrefillStateCache",
    # device-resident state pool (serving/pool.py)
    "DeviceStatePool", "PagedStateCache",
    # deprecated wave shim (serving/loop.py)
    "InjectionServer", "ServeResult",
    # scenario harness (serving/loadgen.py)
    "SCENARIO_NAMES", "SLOContract", "ScenarioSpec", "ScenarioResult",
    "Trace", "evaluate_slo", "get_scenario", "make_trace", "run_scenario",
]
