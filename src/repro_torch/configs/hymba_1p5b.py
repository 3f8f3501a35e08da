"""hymba-1.5b — assigned architecture config."""
from repro_torch.configs.base import ModelConfig, register

# [arXiv:2411.13676] parallel attn+mamba heads; SWA keeps KV bounded
config = register(ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, d_ff=5504,
    vocab=32001, head_dim=64, act="silu", ssm_state=16, ssm_expand=2,
    ssm_head_dim=50, sliding_window=2048, tie_embeddings=True,
))
