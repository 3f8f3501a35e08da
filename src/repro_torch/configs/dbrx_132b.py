"""dbrx-132b — assigned architecture config."""
from repro_torch.configs.base import ModelConfig, register

# [hf:databricks/dbrx-base] 16 experts top-4, fine-grained
config = register(ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=10752,
    vocab=100352, act="silu", n_experts=16, top_k=4, rope_theta=5e5,
    tie_embeddings=False,
))
