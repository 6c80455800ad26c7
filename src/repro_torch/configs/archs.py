"""Registered architectures of the port (the JAX package's ``configs/archs.py``).

The paper's own ranker and the pure-SSM ``mamba2-780m`` are registered so
far; the other architectures come with the slices that port their layers.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

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

# The paper's own production ranker is unspecified; we use a SASRec-class
# sequential ranker over the item vocabulary.
PAPER_RANKER = register(ModelConfig(
    name="itfi-ranker", family="dense",
    n_layers=4, d_model=256, n_heads=8, n_kv_heads=8, d_ff=1024,
    vocab_size=5120, rope_theta=10000.0, tie_embeddings=True,
    source="paper §III ranking model (SASRec-class sequential ranker)",
))
