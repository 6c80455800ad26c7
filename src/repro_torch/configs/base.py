"""Unified model/config system (copy of the JAX package's ``configs/base.py``).

Every architecture is expressed as a ``ModelConfig``, a frozen dataclass.
The port registers only the paper's own ranker so far (``archs.py``); the
MoE/SSM sub-configs and the parameter counts come with the slices that
port those architectures.

Layer-type schedule
-------------------
``layer_kinds()`` returns, per layer, one of ``"attn"`` / ``"ssm"`` — the
sequence-mixing block — and ``mlp_kinds()`` one of ``"dense"`` / ``"moe"``.
This single mechanism expresses dense transformers, MoE transformers, pure
SSMs (mamba2) and the Jamba hybrid (attn:mamba 1:7, MoE every other layer).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

VOCAB_PAD_MULTIPLE = 256


def pad_vocab(v: int, multiple: int = VOCAB_PAD_MULTIPLE) -> int:
    return ((v + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads
    norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    sliding_window: int = 0  # 0 = full attention
    qkv_bias: bool = False  # qwen-style attention bias
    tie_embeddings: bool = False
    # the JAX package's MoEConfig / SSMConfig; None for the dense stacks
    # the port runs so far
    moe: Optional[Any] = None
    ssm: Optional[Any] = None
    # modality frontend stubs (vlm/audio): number of prefix embedding
    # positions supplied externally as precomputed patch/frame embeddings.
    frontend: str = "none"  # none | vision | audio
    # citation for the architecture source
    source: str = ""

    # ------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def vocab_padded(self) -> int:
        return pad_vocab(self.vocab_size)

    # ------------------------------------------------------------------
    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer sequence-mixing block kind ("attn" | "ssm")."""
        kinds = []
        for i in range(self.n_layers):
            if self.ssm is None:
                kinds.append("attn")
            elif self.ssm.attn_period == 0:
                kinds.append("ssm")
            else:
                kinds.append(
                    "attn" if i % self.ssm.attn_period == self.ssm.attn_offset else "ssm"
                )
        return tuple(kinds)

    def mlp_kinds(self) -> Tuple[str, ...]:
        """Per-layer MLP kind ("dense" | "moe" | "none")."""
        kinds = []
        for i in range(self.n_layers):
            if self.family == "ssm":
                kinds.append("none")  # mamba2 blocks have no separate MLP
            elif self.moe is not None and i % self.moe.period == self.moe.offset:
                kinds.append("moe")
            else:
                kinds.append("dense")
        return tuple(kinds)

    def validate(self) -> None:
        assert self.d_model % 16 == 0, f"{self.name}: d_model must divide TP=16"
        assert self.vocab_padded % 256 == 0
        if self.layer_kinds().count("attn"):
            assert self.n_heads * self.head_dim_ >= 1
            assert self.n_heads % self.n_kv_heads == 0, "GQA group must be integral"
        if self.moe is not None:
            assert self.moe.top_k <= self.moe.n_experts


# ----------------------------------------------------------------------
# Registry
# ----------------------------------------------------------------------
_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    cfg.validate()
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> Tuple[str, ...]:
    _ensure_loaded()
    return tuple(sorted(_REGISTRY))


def _ensure_loaded() -> None:
    # import the per-arch modules for their registration side effects
    if _REGISTRY:
        return
    from repro_torch.configs import archs  # noqa: F401

