"""The background snapshot builder's cases of the JAX package's tests, run
on the port.

Every test function of ``tests/test_background_builder.py`` is called as
it is, with its module's feature store, ``Request``, ``PrefillStateCache``
and Gateway factory replaced by the port's (``PagedStateCache`` too,
which one case imports from ``repro.serving.pool`` when it runs): the
off-thread build against the ``run_snapshot`` oracle under concurrent
appends, the sticky worker error, the certification of the handoff
delta, a background-build Gateway bit for bit a synchronous one across a
rollover, the worker off the serving thread, and the rollover-aware
eviction order of the host LRU and the paged cache. The Gateway runs
over the port's engine with the shared ``tiny-test`` weights
(``conftest.tiny_engine`` carried over in fp32) on the CPU.
"""
import functools

import pytest

import test_background_builder as jbb
from conftest import tiny_engine
from repro_torch.core.feature_store import (BatchFeatureStore,
                                            FeatureStoreConfig)
from repro_torch.serving import Gateway, PagedStateCache, ServerConfig
from repro_torch.serving.api import Request
from repro_torch.serving.scheduler import PrefillStateCache
from torch_port import make_injector, port_engine

CASES = sorted(name for name in vars(jbb)
               if name.startswith("test_") and callable(getattr(jbb, name)))


@functools.lru_cache(maxsize=None)
def _port_tiny_engine():
    return port_engine(tiny_engine())


def _make_gateway(policy="inject", engine=None, injector=None,
                  snapshot_offset=0, events=None, seed=0, **cfg_kw):
    """``conftest.make_gateway`` on the port."""
    cfg_kw.setdefault("slate_len", 3)
    cfg_kw.setdefault("cache_entries", 64)
    inj = injector or make_injector("repro_torch", policy, events, seed,
                                    snapshot_offset=snapshot_offset)
    return Gateway(engine if engine is not None else _port_tiny_engine(),
                   inj, ServerConfig(**cfg_kw))


@pytest.mark.parametrize("name", CASES)
def test_reference_case_on_port(monkeypatch, name):
    for attr, value in (("BatchFeatureStore", BatchFeatureStore),
                        ("FeatureStoreConfig", FeatureStoreConfig),
                        ("Request", Request),
                        ("PrefillStateCache", PrefillStateCache),
                        ("make_gateway", _make_gateway),
                        ("tiny_engine", _port_tiny_engine)):
        monkeypatch.setattr(jbb, attr, value)
    monkeypatch.setattr("repro.serving.pool.PagedStateCache",
                        PagedStateCache)
    getattr(jbb, name)()


def test_every_reference_case_collected():
    assert len(CASES) == 13
