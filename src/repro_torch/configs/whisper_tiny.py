"""whisper-tiny — assigned architecture config."""
from repro_torch.configs.base import ModelConfig, register

# [arXiv:2212.04356] enc-dec; conv frontend is a stub (frame embeddings)
config = register(ModelConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, enc_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab=51865, act="gelu", norm="layernorm",
    tie_embeddings=True, mlp_gated=False,
))
