"""starcoder2-7b — assigned architecture config."""
from repro_torch.configs.base import ModelConfig, register

# [arXiv:2402.19173] GQA kv=4, RoPE
config = register(ModelConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, d_ff=18432,
    vocab=49152, act="gelu", norm="layernorm", rope_theta=1e5,
    tie_embeddings=False, mlp_gated=False,
))
