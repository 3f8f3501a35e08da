"""mixtral-8x22b — assigned architecture config."""
from repro_torch.configs.base import ModelConfig, register

# [arXiv:2401.04088] 8 experts top-2
config = register(ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab=32768, act="silu", n_experts=8, top_k=2, rope_theta=1e6,
    tie_embeddings=False, sliding_window=0,
))
