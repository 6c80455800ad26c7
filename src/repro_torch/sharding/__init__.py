"""Sharding rules (``rules.py``, the JAX package's, pure Python) and the
rank-local shards and collectives that stand in for GSPMD (``local.py``)."""
from repro_torch.sharding.rules import (  # noqa: F401
    MeshShape, P, ServingShardings, ShardingRules, SlotPoolShardings,
    axis_size, batch_pspec, cache_pspecs, data_axes, head_pspec,
    mesh_sizes, opt_pspecs, param_pspecs, seq_cache_pspecs,
    serving_pspecs, slot_pool_pspecs)
