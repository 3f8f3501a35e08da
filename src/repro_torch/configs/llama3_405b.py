"""llama3-405b — assigned architecture config."""
from repro_torch.configs.base import ModelConfig, register

# [arXiv:2407.21783] GQA kv=8, 128k vocab
config = register(ModelConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, d_ff=53248,
    vocab=128256, act="silu", rope_theta=5e5, tie_embeddings=False,
))
