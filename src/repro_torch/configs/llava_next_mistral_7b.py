"""llava-next-mistral-7b — assigned architecture config."""
from repro_torch.configs.base import ModelConfig, register

# [hf:llava-hf/llava-v1.6-mistral-7b-hf] anyres tiling stubbed
config = register(ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab=32000, act="silu", rope_theta=1e6, tie_embeddings=False,
))
