"""Registered architectures of the port (the JAX package's ``configs/archs.py``).

The 10 assigned architectures and the paper's own ranker, with the same
fields and source citations. Individual ``configs/<id>.py`` modules
re-export each config for ``--arch <id>`` selection.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig, register

# ---------------------------------------------------------------- ssm
MAMBA2_780M = register(ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=1, d_ff=0,
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, chunk_size=256,
                  attn_period=0),
    tie_embeddings=True,
    source="SSD / state-space duality [arXiv:2405.21060]",
))

# ---------------------------------------------------------------- moe
GRANITE_MOE_3B = register(ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, d_ff=512,
    vocab_size=49155, rope_theta=10000.0,
    moe=MoEConfig(n_experts=40, top_k=8, period=1),
    source="granite 3.0 MoE [hf:ibm-granite/granite-3.0-1b-a400m-base]",
))

MIXTRAL_8X22B = register(ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab_size=32768, rope_theta=1000000.0, sliding_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, period=1),
    source="Mixtral of Experts [arXiv:2401.04088]",
))

# ---------------------------------------------------------------- dense
LLAMA32_1B = register(ModelConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, d_ff=8192,
    vocab_size=128256, rope_theta=500000.0, tie_embeddings=True,
    source="small llama3 [hf:meta-llama/Llama-3.2-1B]",
))

CODEQWEN_7B = register(ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, d_ff=13440,
    vocab_size=92416, rope_theta=1000000.0, qkv_bias=True,
    source="qwen1.5 arch [hf:Qwen/CodeQwen1.5-7B]",
))

COMMAND_R_PLUS = register(ModelConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, d_ff=33792,
    vocab_size=256000, rope_theta=75000000.0,
    source="GQA no-bias [hf:CohereForAI/c4ai-command-r-v01]",
))

DEEPSEEK_67B = register(ModelConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22016,
    vocab_size=102400, rope_theta=10000.0,
    source="llama-arch [arXiv:2401.02954]",
))

# ---------------------------------------------------------------- audio
MUSICGEN_LARGE = register(ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=2048, frontend="audio",
    source="decoder-only over EnCodec tokens [arXiv:2306.05284]; "
           "RoPE substituted for learned positions (DESIGN.md §7)",
))

# ---------------------------------------------------------------- vlm
LLAVA_NEXT_34B = register(ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, d_ff=20480,
    vocab_size=64000, rope_theta=5000000.0, frontend="vision",
    source="anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf]",
))

# ---------------------------------------------------------------- hybrid
JAMBA_52B = register(ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=65536,
    # attn:mamba 1:7 interleave — one attention layer per 8, at offset 3
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, chunk_size=256,
                  attn_period=8, attn_offset=3),
    # MoE every other layer, 16 experts top-2
    moe=MoEConfig(n_experts=16, top_k=2, period=2, offset=1),
    source="Mamba+attn 1:7 interleave, MoE [arXiv:2403.19887]",
))

# ---------------------------------------------------------------- paper
# The paper's own production ranker is unspecified; we use a SASRec-class
# sequential ranker over the item vocabulary — small enough to train for a
# few hundred steps on CPU in examples/ and the A/B harness.
PAPER_RANKER = register(ModelConfig(
    name="itfi-ranker", family="dense",
    n_layers=4, d_model=256, n_heads=8, n_kv_heads=8, d_ff=1024,
    vocab_size=5120, rope_theta=10000.0, tie_embeddings=True,
    source="paper §III ranking model (SASRec-class sequential ranker)",
))

ASSIGNED = (
    "mamba2-780m", "granite-moe-3b-a800m", "llama3.2-1b", "mixtral-8x22b",
    "musicgen-large", "codeqwen1.5-7b", "command-r-plus-104b",
    "llava-next-34b", "jamba-v0.1-52b", "deepseek-67b",
)
