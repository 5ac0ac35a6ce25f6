"""Model and shape configuration (`repro.configs.base`, the part the
port needs).

Every architecture is a `ModelConfig` and every workload cell a
`ShapeSpec`, plain frozen dataclasses copied field for field from the
reference so the two describe the same model and the same batch. The
port registers the configurations (the plain dense family:
Phi-3-mini, MiniCPM-2B, Minitron-8B; Gemma-2 27B's local/global
layout; Qwen3-MoE-30B-A3B's token-choice experts; Mamba2-780M's SSD
mixers; Jamba-1.5-Large's hybrid periods; Whisper-tiny's encoder-decoder;
Llama-3.2-Vision-90B's gated cross-attention; and DeepSeek-V2's
multi-head latent attention over fine-grained experts): all ten of the
reference's.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Shapes (assigned workload cells)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


TRAIN_4K = ShapeSpec("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    num_shared_experts: int = 0
    d_ff_shared: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001
    # every `interval`-th layer is MoE (1 = all layers); offset selects which.
    interval: int = 1
    offset: int = 0


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0          # 0 = direct q projection
    d_head_nope: int = 128
    d_head_rope: int = 64
    d_head_v: int = 128


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    mlp_variant: str = "swiglu"    # swiglu | geglu | relu2 | gelu
    tie_embeddings: bool = True
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    # gemma2-style extras
    attn_softcap: float = 0.0      # 0 = off
    final_softcap: float = 0.0
    sliding_window: int = 0        # 0 = off; used on "local" layers
    local_global_pattern: bool = False  # alternate local/global attention
    sandwich_norms: bool = False   # post-attn/post-ffn extra RMSNorms
    query_scale: float = 0.0       # 0 -> 1/sqrt(head_dim)
    # minicpm-style extras
    residual_scale: float = 1.0   # depth-scaled resid (scale_depth/sqrt(L))
    logit_mult: float = 1.0        # mup-ish output multiplier
    emb_scale: float = 1.0        # emb multiplier (gemma sqrt(d), minicpm)
    # MoE / MLA / Mamba
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    # hybrid (jamba): within a period of `hybrid_period` layers, layer index
    # `hybrid_attn_index` is attention, the rest are mamba mixers.
    hybrid_period: int = 0
    hybrid_attn_index: int = 0
    # enc-dec (whisper backbone)
    n_encoder_layers: int = 0
    encoder_seq: int = 1500        # stub frame-embedding length
    # vlm: every cross_attn_interval-th layer cross-attends to patch embeds
    cross_attn_interval: int = 0
    num_patches: int = 1601
    # numerics / memory policy
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"   # bf16 for >=200B archs
    remat: str = "full"            # none | full | dots
    attn_q_chunk: int = 512        # query-chunked attention block
    # perf knobs (see EXPERIMENTS.md §Perf)
    cast_params_for_loss: bool = False  # bf16 weights before FSDP gathers
    pad_heads_to_tp: int = 0       # pad attn heads to a multiple (0 = off)
    bf16_psum: bool = False        # barrier sublayer outputs so TP/grad
                                   # all-reduces stay bf16 (XLA otherwise
                                   # hoists the f32 convert above the AR)
    # training
    learning_rate: float = 3e-4
    schedule: str = "cosine"       # cosine | wsd
    warmup_steps: int = 100
    grad_accum: int = 8            # microbatch accumulation for train_4k
    # which shapes this arch supports (long_500k only for sub-quadratic)
    supports_long_context: bool = False

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_counts(self) -> Tuple[int, int]:
        """Returns (total_params, active_params) analytically."""
        from repro_torch.models.params import count_params  # lazy
        return count_params(self)

    def shapes(self) -> Tuple[ShapeSpec, ...]:
        """The workload cells this arch runs: train_4k, prefill_32k,
        decode_32k, and long_500k where `supports_long_context`."""
        out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
        if self.supports_long_context:
            out.append(LONG_500K)
        return tuple(out)


# registry ------------------------------------------------------------------

_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    if _REGISTRY:
        return
    from repro_torch.configs import (  # noqa: F401
        deepseek_v2_236b, gemma2_27b, jamba_1_5_large_398b,
        llama_3_2_vision_90b, mamba2_780m, minicpm_2b, minitron_8b,
        phi3_mini_3_8b, qwen3_moe_30b_a3b, whisper_tiny)


# ---------------------------------------------------------------------------
# Reduced ("smoke") variants: same family wiring, tiny dims.
# ---------------------------------------------------------------------------


def smoke_config(name: str) -> ModelConfig:
    """A reduced config of the same family for CPU smoke tests (the
    reference's reduction, field for field)."""
    cfg = get_config(name)
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=max(2, min(4, cfg.n_layers)),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads else 0,
        head_dim=16,
        d_ff=128,
        vocab_size=503,         # deliberately odd: exercises replication
        attn_q_chunk=32,
        remat="none",
        grad_accum=2,
        warmup_steps=5,           # smoke runs are O(10) steps
        learning_rate=1e-3,
    )
    if cfg.moe is not None:
        # capacity_factor 8: tiny smoke groups would otherwise drop tokens
        # nondeterministically between prefill/decode shapes
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=2, d_ff_expert=64,
            num_shared_experts=min(cfg.moe.num_shared_experts, 1),
            d_ff_shared=64, capacity_factor=8.0)
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(kv_lora_rank=32, d_head_nope=16, d_head_rope=8,
                              d_head_v=16)
    if cfg.mamba is not None:
        kw["mamba"] = dataclasses.replace(
            cfg.mamba, d_state=16, head_dim=16, chunk_size=16)
    if cfg.hybrid_period:
        kw["hybrid_period"] = 4
        kw["hybrid_attn_index"] = 0
        kw["n_layers"] = 4
        if cfg.moe is not None:
            kw["moe"] = dataclasses.replace(kw["moe"], interval=2, offset=1)
    if cfg.n_encoder_layers:
        kw["n_encoder_layers"] = 2
        kw["encoder_seq"] = 24
    if cfg.cross_attn_interval:
        kw["cross_attn_interval"] = 2
        kw["num_patches"] = 12
        kw["n_layers"] = 4
    return cfg.replace(**kw)
