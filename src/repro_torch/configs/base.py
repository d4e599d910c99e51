"""Architecture + shape configuration system (the port's own copy of
``repro.configs.base``; the dataclasses are pure Python and identical).

One :class:`ArchConfig` per assigned architecture (exact published dims, see
per-arch files); :class:`ShapeSpec` defines the assigned input shapes.  The
``reduced()`` method derives the family-preserving small config used by the
per-arch CPU tests.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention flavor
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int | None = None
    global_layer_every: int | None = None   # every k-th layer is global (gemma3: 6)
    global_layers: tuple[int, ...] = ()     # explicit global layer ids (hymba)
    tie_embeddings: bool = False
    embed_scale: float = 1.0                # embedding multiplier (gemma: sqrt(d))
    logit_divisor: float = 1.0              # minicpm3: d_model / dim_model_base
    residual_scale: float = 1.0             # minicpm3: scale_depth / sqrt(2L)
    norm_plus_one: bool = False             # gemma-style (1+w) RMSNorm
    post_norms: bool = False                # gemma3 sandwich norms

    # MLA (minicpm3 / deepseek lineage)
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    expert_d_ff: int = 0
    moe_layer_step: int = 1                 # MoE every k-th layer (llama4: 2)
    first_dense_layers: int = 0             # deepseek: layer 0 dense
    moe_capacity_factor: float = 1.25
    router_softmax_after_topk: bool = True  # deepseek normalizes top-k gates

    # SSM (mamba2 / hymba mamba branch)
    d_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    d_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_groups: int = 1

    # hybrid (hymba)
    n_meta_tokens: int = 0

    # encoder-decoder (whisper)
    n_encoder_layers: int = 0
    encoder_len: int = 1500                 # stub frontend output frames

    # vlm (internvl2)
    n_patches: int = 0                      # stub visual tokens per example
    vit_embed_dim: int = 0

    norm_eps: float = 1e-6
    act: str = "silu"
    dtype: str = "bfloat16"            # compute/activation dtype
    param_dtype: str = "float32"       # master weights
    opt_state_dtype: str = "float32"   # Adam m/v

    # shapes this arch skips, with reasons (DESIGN.md skip notes)
    skip_shapes: tuple[tuple[str, str], ...] = ()

    # ---- derived ----
    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a 256 multiple so embedding/logit tensors shard
        over the 16-way model axis (standard practice; logits beyond
        vocab_size are sliced off at the serving boundary)."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        if self.ssm_heads and self.ssm_head_dim:
            return self.ssm_heads * self.ssm_head_dim
        return self.ssm_expand * self.d_model

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def is_moe_layer(self, idx: int) -> bool:
        if self.n_experts == 0 or idx < self.first_dense_layers:
            return False
        return (idx - self.first_dense_layers) % self.moe_layer_step == (
            self.moe_layer_step - 1
        )

    def skips(self, shape_name: str) -> str | None:
        for s, why in self.skip_shapes:
            if s == shape_name:
                return why
        return None

    def reduced(self) -> "ArchConfig":
        """Family-preserving tiny config for CPU smoke tests."""
        small = {
            "n_layers": min(self.n_layers, 4 if self.family != "moe" else 4),
            "d_model": 64,
            "n_heads": 4,
            "n_kv_heads": min(self.n_kv_heads, 4) if self.n_kv_heads else 0,
            "head_dim": 16,
            "d_ff": 128,
            "vocab_size": 512,
            "dtype": "float32",
        }
        if self.use_mla:
            small.update(q_lora_rank=32, kv_lora_rank=16, qk_nope_dim=8,
                         qk_rope_dim=8, v_head_dim=16, head_dim=16)
        if self.n_experts:
            # high capacity factor: the reduced config is for correctness
            # smoke tests, where capacity drops would mask real bugs
            small.update(n_experts=8, top_k=min(self.top_k, 2),
                         expert_d_ff=64, n_shared_experts=self.n_shared_experts,
                         moe_capacity_factor=4.0)
        if self.d_state:
            small.update(d_state=16, ssm_heads=4, ssm_head_dim=16, ssm_chunk=16)
        if self.n_encoder_layers:
            small.update(n_encoder_layers=2, encoder_len=32)
        if self.n_patches:
            small.update(n_patches=8, vit_embed_dim=48)
        if self.n_meta_tokens:
            small.update(n_meta_tokens=8)
        if self.sliding_window:
            small.update(sliding_window=32)
        return dataclasses.replace(self, **small)


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  (populates the registry)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def all_configs() -> dict[str, ArchConfig]:
    import repro_torch.configs  # noqa: F401

    return dict(_REGISTRY)
