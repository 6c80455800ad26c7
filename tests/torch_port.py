"""Helpers shared by the port's parity tests (``tests/test_torch_*.py``).

``port_cfg`` turns a JAX package ``ModelConfig`` into the port's, with its
``SSMConfig`` converted too, so that the two packages' configs compare
field by field. MoE configs are not ported: a JAX ``MoEConfig`` raises.
"""
import dataclasses

from repro_torch.configs import ModelConfig, SSMConfig


def port_cfg(cfg) -> ModelConfig:
    """The port's ``ModelConfig`` equal to the JAX one ``cfg``."""
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: MoE is not ported")
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(ModelConfig)}
    if cfg.ssm is not None:
        fields["ssm"] = SSMConfig(**dataclasses.asdict(cfg.ssm))
    return ModelConfig(**fields)
