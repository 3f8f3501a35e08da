"""granite-8b — assigned architecture config."""
from repro_torch.configs.base import ModelConfig, register

# [arXiv:2405.04324] llama-arch, code
config = register(ModelConfig(
    name="granite-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=49152, act="silu", rope_theta=1e4, tie_embeddings=True,
))
