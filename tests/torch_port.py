"""Helpers shared by the port's parity tests (``tests/test_torch_*.py``).

``port_cfg`` turns a JAX package ``ModelConfig`` into the port's, with its
``SSMConfig`` and ``MoEConfig`` converted too, so that the two packages'
configs compare field by field.
``make_injector`` builds either package's feature plane (batch store,
realtime service, injector) over the same seeded events, and
``port_engine`` the port's engine with a JAX engine's weights.
"""
import dataclasses

from repro_torch.configs import ModelConfig, MoEConfig, SSMConfig


def port_cfg(cfg) -> ModelConfig:
    """The port's ``ModelConfig`` equal to the JAX one ``cfg``."""
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(ModelConfig)}
    if cfg.ssm is not None:
        fields["ssm"] = SSMConfig(**dataclasses.asdict(cfg.ssm))
    if cfg.moe is not None:
        fields["moe"] = MoEConfig(**dataclasses.asdict(cfg.moe))
    return ModelConfig(**fields)


def make_injector(pkg="repro_torch", policy="inject", events=None, seed=0,
                  n_users=None, device="cpu", **store_kw):
    """A ``FeatureInjector`` of package ``pkg`` (``"repro"`` or
    ``"repro_torch"``) over a batch store and a realtime service fed the
    same events: ``events`` (users, items, ts), by default
    ``conftest.seed_events(seed)``. ``store_kw`` goes into
    ``FeatureStoreConfig``. The port's injector runs on ``device``."""
    import importlib

    from conftest import FEATURE_LEN, N_USERS, seed_events

    fs = importlib.import_module(f"{pkg}.core.feature_store")
    rt = importlib.import_module(f"{pkg}.core.realtime")
    inj = importlib.import_module(f"{pkg}.core.injection")
    n_users = n_users or N_USERS
    store = fs.BatchFeatureStore(fs.FeatureStoreConfig(
        n_users=n_users, feature_len=FEATURE_LEN, **store_kw))
    rts = rt.RealtimeFeatureService(rt.RealtimeConfig(
        n_users=n_users, buffer_len=8, ingest_latency=0))
    us, its, tss = events if events is not None else seed_events(seed)
    store.extend(us, its, tss)
    rts.extend(us, its, tss)
    kw = {"device": device} if pkg == "repro_torch" else {}
    return inj.FeatureInjector(
        inj.InjectionConfig(policy=policy, feature_len=FEATURE_LEN), store,
        rts, **kw)


def port_engine(jeng, device="cpu"):
    """The port's ``ServingEngine`` with the JAX engine ``jeng``'s
    config, serving shapes and weights (carried across in fp32)."""
    import jax
    import numpy as np

    from repro_torch.serving import ServingConfig, ServingEngine
    from repro_torch.weights import params_from_numpy

    s = jeng.scfg
    cfg = port_cfg(jeng.cfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jeng.params), cfg,
                               device=device)
    return ServingEngine(cfg, params, ServingConfig(
        max_batch=s.max_batch, prefill_len=s.prefill_len,
        inject_len=s.inject_len, cache_capacity=s.cache_capacity),
        device=device)
