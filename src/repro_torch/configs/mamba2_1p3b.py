"""mamba2-1.3b — assigned architecture config."""
from repro_torch.configs.base import ModelConfig, register

# [arXiv:2405.21060] SSD (state-space duality); attention-free
config = register(ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50280, ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    tie_embeddings=True,
))
