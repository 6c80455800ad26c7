"""Unified model/config system (copy of the JAX package's ``configs/base.py``).

Every architecture is expressed as a ``ModelConfig``, a frozen dataclass;
the port registers the same ones (``archs.py``).

Layer-type schedule
-------------------
``layer_kinds()`` returns, per layer, one of ``"attn"`` / ``"ssm"`` — the
sequence-mixing block — and ``mlp_kinds()`` one of ``"dense"`` / ``"moe"``.
This single mechanism expresses dense transformers, MoE transformers, pure
SSMs (mamba2) and the Jamba hybrid (attn:mamba 1:7, MoE every other layer).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

VOCAB_PAD_MULTIPLE = 256


def pad_vocab(v: int, multiple: int = VOCAB_PAD_MULTIPLE) -> int:
    return ((v + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    # which layers get an MoE MLP: every `period` layers, offset `offset`.
    period: int = 1
    offset: int = 0
    # router options
    router_jitter: float = 0.0
    load_balance_coef: float = 0.01
    # tokens-per-expert buffer size = seq * top_k * capacity_factor / E.
    # Train default 1.25 (GShard-style dropping); set to n_experts/top_k
    # (or use ``no_drop()``) for drop-free eval/serving.
    capacity_factor: float = 1.25

    def no_drop(self) -> "MoEConfig":
        return dataclasses.replace(
            self, capacity_factor=float(self.n_experts) / self.top_k)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    conv_width: int = 4
    chunk_size: int = 256
    dt_min: float = 0.001
    dt_max: float = 0.1
    # which layers are SSM: Jamba uses attn at (i % period == attn_offset),
    # SSM elsewhere; pure mamba2 has attn_period=0 (never attention).
    attn_period: int = 0
    attn_offset: int = 0


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
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
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

    @property
    def d_inner(self) -> int:
        s = self.ssm or SSMConfig()
        return s.expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        s = self.ssm or SSMConfig()
        return self.d_inner // s.head_dim

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

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Total parameter count (true vocab, not padded)."""
        d, hd = self.d_model, self.head_dim_
        total = self.vocab_size * d  # embed
        if not self.tie_embeddings:
            total += self.vocab_size * d  # lm head
        lk, mk = self.layer_kinds(), self.mlp_kinds()
        for kind, mlp in zip(lk, mk):
            total += 2 * d  # two norms (scale only)
            if kind == "attn":
                total += d * self.n_heads * hd  # q
                total += 2 * d * self.n_kv_heads * hd  # k, v
                total += self.n_heads * hd * d  # o
                if self.qkv_bias:
                    total += (self.n_heads + 2 * self.n_kv_heads) * hd
            else:  # ssm (mamba2)
                s = self.ssm or SSMConfig()
                din, nh = self.d_inner, self.n_ssm_heads
                total += d * (2 * din + 2 * s.d_state + nh)  # in_proj
                total += s.conv_width * (din + 2 * s.d_state)  # conv
                total += nh * 2  # A_log, D
                total += din  # gate norm scale
                total += din * d  # out_proj
            if mlp == "dense":
                total += 3 * d * self.d_ff  # gate, up, down (swiglu)
            elif mlp == "moe":
                m = self.moe
                total += d * m.n_experts  # router
                total += m.n_experts * 3 * d * self.d_ff
        total += d  # final norm
        return total

    def active_param_count(self) -> int:
        """Parameters active per token (MoE top-k instead of all experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        n_moe_layers = sum(1 for k in self.mlp_kinds() if k == "moe")
        inactive = n_moe_layers * (m.n_experts - m.top_k) * 3 \
            * self.d_model * self.d_ff
        return self.param_count() - inactive

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


def reduced(cfg: ModelConfig, n_layers: int = 2, d_model: int = 256,
            max_experts: int = 4, vocab: int = 512) -> ModelConfig:
    """A tiny same-family variant for CPU smoke tests (2L, d_model<=512, <=4e)."""
    n_heads = max(2, min(cfg.n_heads, 4))
    n_kv = max(1, min(cfg.n_kv_heads, 2))
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(
            cfg.moe, n_experts=min(cfg.moe.n_experts, max_experts),
            top_k=min(cfg.moe.top_k, 2))
    ssm = None
    if cfg.ssm is not None:
        ssm = dataclasses.replace(
            cfg.ssm, d_state=32, head_dim=32, chunk_size=32,
            attn_period=min(cfg.ssm.attn_period, n_layers) if cfg.ssm.attn_period else 0,
            attn_offset=min(cfg.ssm.attn_offset, n_layers - 1))
    return dataclasses.replace(
        cfg, name=cfg.name + "-reduced", n_layers=n_layers, d_model=d_model,
        n_heads=n_heads, n_kv_heads=n_kv, head_dim=d_model // n_heads,
        d_ff=max(64, min(cfg.d_ff, 2 * d_model)), vocab_size=vocab,
        sliding_window=min(cfg.sliding_window, 64) if cfg.sliding_window else 0,
        moe=moe, ssm=ssm)
