"""Model/shape configuration system.

Every assigned architecture is a ``ModelConfig``; every assigned input shape
is a ``ShapeSpec``.  ``supports(cfg, shape)`` encodes the skip rules from the
assignment (encoder-decoder has no 32k/500k decode; ``long_500k`` requires a
sub-quadratic sequence mixer).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

REGISTRY: dict[str, "ModelConfig"] = {}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 => d_model // n_heads
    act: str = "silu"           # silu => SwiGLU, gelu => GeGLU/MLP
    mlp_gated: bool = True      # False => plain 2-matrix MLP (starcoder2)
    norm: str = "rmsnorm"       # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    tie_embeddings: bool = True
    sliding_window: int = 0     # 0 = full attention
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    # encoder-decoder (whisper): n_layers = decoder depth
    enc_layers: int = 0
    # modality frontend stubs
    audio_frames_default: int = 1500   # whisper 30 s @ 50 Hz after conv stub
    vlm_patches_default: int = 576     # llava-next base-res patch count

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def vocab_padded(self) -> int:
        """Embedding rows padded to 256 (vocab/tensor-parallel sharding)."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def has_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + layers)."""
        d, f, L = self.d_model, self.d_ff, self.n_layers
        hd, H, Hk = self.hd, self.n_heads, self.n_kv_heads
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        attn = d * H * hd + 2 * d * Hk * hd + H * hd * d if self.has_attention else 0
        glu = (3 if self.mlp_gated else 2) * d * f
        if self.family == "moe":
            ff = self.n_experts * glu + d * self.n_experts
        elif self.family == "ssm":
            ff = 0
        else:
            ff = glu
        ssm = 0
        if self.has_ssm:
            di, N, Hm = self.d_inner, self.ssm_state, self.ssm_heads
            ssm = d * (2 * di + 2 * N + Hm) + di * d + 2 * di
        per_layer = attn + ff + ssm + 2 * d
        total = emb + L * per_layer
        if self.family == "encdec":
            # encoder layers + cross attention in decoder
            total += self.enc_layers * (attn + glu + 2 * d) + L * attn
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.family != "moe":
            return self.n_params()
        d, f, L = self.d_model, self.d_ff, self.n_layers
        glu = (3 if self.mlp_gated else 2) * d * f
        dense = self.n_params() - L * self.n_experts * glu
        return dense + L * self.top_k * glu

    def scaled(self, **overrides) -> "ModelConfig":
        return dataclasses.replace(self, **overrides)

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        return self.scaled(
            name=self.name + "-smoke",
            n_layers=2,
            d_model=64,
            n_heads=4,
            n_kv_heads=2 if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab=256,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=8,
            enc_layers=2 if self.enc_layers else 0,
            sliding_window=min(self.sliding_window, 32) if self.sliding_window else 0,
            audio_frames_default=24,
            vlm_patches_default=16,
        )


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def register(cfg: ModelConfig) -> ModelConfig:
    REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs.all  # noqa: F401  (populate registry)
    return REGISTRY[name]


def all_configs() -> dict[str, ModelConfig]:
    import repro_torch.configs.all  # noqa: F401
    return dict(REGISTRY)


def supports(cfg: ModelConfig, shape: ShapeSpec) -> Optional[str]:
    """None if (cfg, shape) runs; else a skip reason (DESIGN.md §4)."""
    if cfg.family == "encdec" and shape.kind == "decode":
        return "SKIP(enc-dec: no long-KV decode step)"
    if shape.name == "long_500k":
        sub_quadratic = cfg.family in ("ssm", "hybrid")
        if not sub_quadratic:
            return "SKIP(long-context: needs sub-quadratic attention)"
    return None
