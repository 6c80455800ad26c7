"""Registered architectures of the port (the JAX package's ``configs/archs.py``).

Only the paper's own ranker is registered so far; the other architectures
come with the slices that port their layers.
"""
from repro_torch.configs.base import ModelConfig, register

# The paper's own production ranker is unspecified; we use a SASRec-class
# sequential ranker over the item vocabulary.
PAPER_RANKER = register(ModelConfig(
    name="itfi-ranker", family="dense",
    n_layers=4, d_model=256, n_heads=8, n_kv_heads=8, d_ff=1024,
    vocab_size=5120, rope_theta=10000.0, tie_embeddings=True,
    source="paper §III ranking model (SASRec-class sequential ranker)",
))
