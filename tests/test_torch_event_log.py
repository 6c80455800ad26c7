"""The event-log cases of the JAX package's tests, run on the port.

Every test function of ``tests/test_event_log.py`` and
``tests/test_event_log_tiered.py`` is called as it is, with its module's
``EventLog`` (and ``BackgroundCompactor``) replaced by the port's
(``repro_torch.core.event_log``): growth, columnar ingest, bounds,
materialize's alignment and tie order, the pending-merge path, tiered
compaction, demotion, eviction, the exactness contract against an
untiered oracle, the background compactor and concurrent readers.
"""
import pytest

import test_event_log as jlog
import test_event_log_tiered as jtier
from repro_torch.core.event_log import BackgroundCompactor, EventLog

CASES = [(mod, name) for mod in (jlog, jtier) for name in sorted(vars(mod))
         if name.startswith("test_") and callable(getattr(mod, name))]


@pytest.mark.parametrize("mod,name", CASES,
                         ids=[f"{m.__name__}::{n}" for m, n in CASES])
def test_reference_case_on_port(monkeypatch, mod, name):
    monkeypatch.setattr(mod, "EventLog", EventLog)
    if hasattr(mod, "BackgroundCompactor"):
        monkeypatch.setattr(mod, "BackgroundCompactor", BackgroundCompactor)
    getattr(mod, name)()


def test_every_reference_case_collected():
    assert len([c for c in CASES if c[0] is jlog]) == 11
    assert len([c for c in CASES if c[0] is jtier]) == 16
