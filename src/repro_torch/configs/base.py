"""Model / run configuration dataclasses.

One :class:`ModelConfig` describes any of the assigned architectures; the
``family`` field selects the model implementation:

* ``dense``  — decoder-only transformer (GQA, RoPE): glm4, qwen2, granite,
  minitron, and the llava/mistral backbone.
* ``moe``    — dense transformer with MoE FFN (dbrx) or MLA+MoE (deepseek).
* ``ssm``    — RWKV6 "Finch" (attention-free, data-dependent decay).
* ``hybrid`` — RecurrentGemma (RG-LRU recurrent blocks + local attention).
* ``encdec`` — Whisper (audio encoder + text decoder, conv frontend stub).
* ``vlm``    — LLaVA-NeXT (dense backbone + anyres patch-embedding stub).

``smoke()`` derives a reduced config of the same family for CPU tests.

A copy of ``repro.configs.base`` (pure data): the port keeps its own so
that it imports nothing of the JAX package.  ``tests/test_torch_configs.py``
holds the two copies equal.  Fields that only the JAX package reads
(``use_scan``, ``remat``, ``sequence_parallel``...) are kept so that the
configs compare field by field.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "shape_applicable"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


#: The assigned LM-family shape set (identical across the 10 archs).
SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None    # default d_model // n_heads
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    qkv_bias: bool = False            # qwen2
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0
    moe_top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0         # deepseek shared experts
    n_dense_layers: int = 0           # leading dense (non-MoE) layers
    capacity_factor: float = 1.25
    moe_impl: str = "dense"           # 'dense' (einsum dispatch) | 'scatter'
    moe_group_size: int = 1024        # tokens per dispatch group (dense impl)

    # --- MLA (deepseek) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    mla_absorb: bool = False          # matrix-absorbed decode (§Perf)

    # --- hybrid / local attention ---
    attn_window: int = 0              # 0 = full; >0 = sliding window
    block_pattern: Tuple[str, ...] = ()  # e.g. ('R','R','A') cycle (hybrid)
    rglru_conv_width: int = 4

    # --- rwkv6 ---
    rwkv_head_dim: int = 64
    wkv_impl: str = "xla"             # 'xla' scan | 'kernel' (Pallas chunked)

    # --- encdec (whisper) ---
    n_encoder_layers: int = 0
    n_audio_ctx: int = 1500           # encoder positions (stub frontend)
    max_positions: int = 32768        # learned decoder positional table
                                      # (whisper ships 448; sized for the
                                      # assigned 32k decode shapes)

    # --- vlm (llava) ---
    n_img_tokens: int = 576           # patch embeddings per image (stub)

    # --- execution ---
    dtype: str = "bfloat16"
    attention_impl: str = "xla"       # 'xla' | 'flash' (Pallas, TPU only)
    remat: str = "block"              # 'none' | 'block'
    use_scan: bool = True             # scan over layers (small HLO)
    loss_chunk_size: int = 512        # chunked CE: never materialize [B,S,V]
    attn_q_chunk: int = 256           # blockwise attention q-chunk (0 = off)
    sequence_parallel: bool = True    # SP: shard saved activations over TP
    hoist_kv_gather: bool = True      # gather K/V once, not per q-chunk

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ------------------------------------------------------------------
    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """True if decode at 500k context is sub-quadratic / O(window)."""
        return self.family in ("ssm", "hybrid")

    @property
    def n_rec_layers(self) -> int:
        if not self.block_pattern:
            return 0
        full, rem = divmod(self.n_layers, len(self.block_pattern))
        pat = list(self.block_pattern) * full + list(self.block_pattern)[:rem]
        return sum(1 for b in pat if b == "R")

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kind sequence for hybrid models ('R'/'A')."""
        if not self.block_pattern:
            return tuple("A" for _ in range(self.n_layers))
        full, rem = divmod(self.n_layers, len(self.block_pattern))
        pat = list(self.block_pattern) * full + list(self.block_pattern)[:rem]
        return tuple(pat)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        hd = self.head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.use_mla:
            qk_hd = self.qk_nope_head_dim + self.qk_rope_head_dim
            attn = (
                d * self.q_lora_rank
                + self.q_lora_rank * self.n_heads * qk_hd
                + d * (self.kv_lora_rank + self.qk_rope_head_dim)
                + self.kv_lora_rank * self.n_heads * (self.qk_nope_head_dim + self.v_head_dim)
                + self.n_heads * self.v_head_dim * d
            )
        else:
            attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        if self.family == "ssm":
            attn = 4 * d * d + d * self.d_model // 16  # rwkv time-mix approx
        dense_ffn = 3 * d * f
        per_layer = attn + dense_ffn
        total = emb + L * (attn + 0)
        if self.n_experts:
            expert_ffn = 3 * d * self.d_ff_expert
            shared = self.n_shared_experts * expert_ffn
            moe_layers = L - self.n_dense_layers
            total += (
                self.n_dense_layers * dense_ffn
                + moe_layers * (self.n_experts * expert_ffn + shared + d * self.n_experts)
            )
        else:
            total += L * dense_ffn
        return int(total)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k + shared only)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        expert_ffn = 3 * d * self.d_ff_expert
        moe_layers = self.n_layers - self.n_dense_layers
        inactive = moe_layers * (self.n_experts - self.moe_top_k) * expert_ffn
        return int(self.param_count() - inactive)

    # ------------------------------------------------------------------
    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        kw = dict(
            name=self.name + "-smoke",
            family=self.family,
            n_layers=min(self.n_layers, 2 if not self.block_pattern else 3),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) or 1,
            d_ff=128,
            vocab_size=256,
            head_dim=16,
            rope_theta=self.rope_theta,
            qkv_bias=self.qkv_bias,
            attn_window=min(self.attn_window, 32) if self.attn_window else 0,
            block_pattern=self.block_pattern,
            rglru_conv_width=self.rglru_conv_width,
            rwkv_head_dim=16,
            dtype="float32",
            attention_impl="xla",
            use_scan=self.use_scan,
        )
        if self.n_experts:
            kw.update(
                n_experts=4, moe_top_k=min(self.moe_top_k, 2), d_ff_expert=32,
                n_shared_experts=min(self.n_shared_experts, 1),
                n_dense_layers=min(self.n_dense_layers, 1),
                capacity_factor=self.capacity_factor, moe_impl=self.moe_impl,
            )
        if self.use_mla:
            kw.update(
                use_mla=True, q_lora_rank=32, kv_lora_rank=16,
                qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                head_dim=24,
            )
        if self.family == "encdec":
            kw.update(n_encoder_layers=2, n_audio_ctx=16)
        if self.family == "vlm":
            kw.update(n_img_tokens=8)
        return ModelConfig(**kw)


def shape_applicable(config: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether an (arch, shape) cell runs or is a documented skip."""
    if shape.name == "long_500k" and not config.supports_long_context:
        return False, (
            "full-attention arch: O(S^2) attention at 524,288 context is "
            "infeasible; long_500k runs only for SSM/hybrid (DESIGN.md §4)"
        )
    return True, ""
