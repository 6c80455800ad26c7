"""The paper's contribution: inference-time feature injection (ITFI).

  event_log      — columnar append-only event log (the feature-plane SoA)
  feature_store  — batch "daily job" feature snapshots (§III-A)
  realtime       — streaming real-time feature service (§III-B, Fig. 2)
  injection      — the merge + inject-as-if-batch operator (§III-B)
  pipeline       — two-stage recommend: retrieval -> ranking (§III)
"""
from repro_torch.core.event_log import EventLog  # noqa: F401
from repro_torch.core.feature_store import (  # noqa: F401
    BatchFeatureStore, FeatureStoreConfig)
from repro_torch.core.injection import (  # noqa: F401
    FeatureInjector, InjectionConfig)
from repro_torch.core.pipeline import (  # noqa: F401
    PipelineConfig, RecommenderPlatform)
from repro_torch.core.realtime import (  # noqa: F401
    RealtimeConfig, RealtimeFeatureService)
