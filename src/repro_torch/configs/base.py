"""Model/shape configuration schema + the assigned input-shape grid.

A copy of the JAX package's ``repro/configs/base.py`` (plain dataclasses,
no JAX).  Every architecture has a module ``repro_torch/configs/<id>.py``
exposing ``CONFIG`` (the exact published numbers, source cited) and
``smoke()`` (a reduced same-family config for CPU tests), each a copy of
the reference's; ``repro_torch.configs.registry`` resolves ``--arch``
names.  The configs are data: the fields that describe the TPU mesh
(``remat``, ``n_micro``, ``cast_params_once``, ``sharded_xent``,
``constrain_grads``, ``moe_impl``) are carried so both packages load equal
configs, and the port's serving path reads none of them.

The input-shape grid (assigned, LM-family):
  train_4k     seq 4096,   global_batch 256  -> train_step
  prefill_32k  seq 32768,  global_batch 32   -> prefill_step
  decode_32k   seq 32768,  global_batch 128  -> decode_step (1 new token)
  long_500k    seq 524288, global_batch 1    -> decode_step; SSM/hybrid/
               sliding-window archs only (sub-quadratic requirement)
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    source: str  # citation for the numbers

    # trunk
    n_layers: int = 0
    d_model: int = 0
    n_heads: int = 0
    n_kv_heads: int = 0
    d_head: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    act: str = "swiglu"  # swiglu | geglu | gelu
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    tie_embeddings: bool = False

    # attention
    attn_kind: str = "gqa"  # gqa | mla | none
    rope_theta: float = 1e4
    window: Optional[int] = None  # sliding-window size (local layers)
    global_every: int = 0  # gemma3: every Nth layer is global (5:1 -> 6)
    rope_theta_global: Optional[float] = None  # gemma3 global layers
    q_chunk: int = 512
    kv_chunk: int = 1024

    # MLA (deepseek)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "psum"  # local | psum | a2a
    aux_loss_coef: float = 0.001

    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 256
    ssm_conv: int = 4

    # hybrid (zamba2): shared attention block every N mamba layers
    attn_every: int = 0
    # enc-dec (seamless)
    n_dec_layers: int = 0
    dec_ratio: int = 4  # decoder seq = seq // dec_ratio for train shapes
    # modality frontend stub (vlm/audio): inputs arrive as embeddings
    frontend: Optional[str] = None  # patch | frames
    n_patches: int = 0

    # numerics / training
    dtype: str = "bfloat16"
    remat: bool = True
    n_micro: int = 8  # grad-accumulation microbatches for train_4k
    # Perf lever: cast f32 params to bf16 ONCE per train step (outside the
    # microbatch scan) so FSDP weight all-gathers move bf16 and are hoisted
    # loop-invariant — vs per-use casts after f32 gathers (baseline).
    cast_params_once: bool = False
    # Perf lever: zero-pad attention q-heads to this count at init so the
    # QKV/O projections AND the attention einsums shard over the model axis
    # when n_heads doesn't divide it.  Semantics-preserving: padded wq/wo
    # slices are zero, their gradients are identically zero.
    pad_heads_to: Optional[int] = None
    # Perf lever: vocab-sharded cross entropy (where/iota label pick instead
    # of take_along_axis, which GSPMD can only lower by replicating the
    # vocab-sharded logits).
    sharded_xent: bool = False
    # Perf lever: constrain gradients to the parameter shardings before the
    # optimizer so GSPMD emits reduce-scatter for the data-axis grad
    # reduction instead of all-reduce(+slice) — the FSDP grad flow.
    constrain_grads: bool = False

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell."""
        return self.family in ("ssm", "hybrid") or (
            self.window is not None and self.global_every > 0
        ) or (self.window is not None and self.global_every == 0)

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs)."""
        d, v = self.d_model, self.vocab_size
        n = v * d  # embedding
        if not self.tie_embeddings and self.family != "encdec":
            n += v * d  # unembed? (we tie by default when flag set)
        per_attn = 0
        if self.attn_kind == "gqa":
            per_attn = d * self.n_heads * self.d_head * 2 + \
                d * self.n_kv_heads * self.d_head * 2
        elif self.attn_kind == "mla":
            ql = self.q_lora_rank
            per_attn = (
                (d * ql + ql * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim))
                if ql
                else d * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
            )
            per_attn += d * (self.kv_lora_rank + self.qk_rope_dim)
            per_attn += self.kv_lora_rank * self.n_heads * (
                self.qk_nope_dim + self.v_head_dim
            )
            per_attn += self.n_heads * self.v_head_dim * d
        per_mlp = (
            3 * d * self.d_ff if self.act in ("swiglu", "geglu") else 2 * d * self.d_ff
        )
        per_moe = 0
        if self.n_experts:
            per_moe = d * self.n_experts + 3 * self.n_experts * d * self.moe_d_ff
            per_moe += 3 * d * self.moe_d_ff * self.n_shared_experts
        per_ssm = 0
        if self.ssm_state:
            d_in = self.ssm_expand * d
            h = d_in // self.ssm_head_dim
            gn = self.ssm_groups * self.ssm_state
            per_ssm = d * (2 * d_in + 2 * gn + h) + d_in * d + \
                self.ssm_conv * (d_in + 2 * gn)

        if self.family == "dense" or self.family == "vlm":
            n += self.n_layers * (per_attn + per_mlp)
        elif self.family == "moe":
            n += self.first_dense_layers * (per_attn + per_mlp)
            n += (self.n_layers - self.first_dense_layers) * (per_attn + per_moe)
        elif self.family == "ssm":
            n += self.n_layers * per_ssm
        elif self.family == "hybrid":
            n += self.n_layers * per_ssm
            n += per_attn + per_mlp  # one shared transformer block
        elif self.family == "encdec":
            n += self.n_layers * (per_attn + per_mlp)
            n += self.n_dec_layers * (2 * per_attn + per_mlp)
        return n

    def active_param_count(self) -> int:
        """Active (per-token) params — MoE counts top_k + shared experts."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        per_attn_mlp = self.param_count() - (
            (self.n_layers - self.first_dense_layers)
            * (d * self.n_experts + 3 * self.n_experts * d * self.moe_d_ff)
        )
        active_moe = (self.n_layers - self.first_dense_layers) * (
            3 * self.top_k * d * self.moe_d_ff + d * self.n_experts
        )
        return per_attn_mlp + active_moe


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(applicable?, reason-if-not) per the assignment's skip rules."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, (
            "long_500k requires sub-quadratic attention; "
            f"{cfg.name} is pure full-attention (skip noted in DESIGN.md)"
        )
    return True, ""
