"""Model + parallelism configuration dataclasses.

Every architecture in the assigned pool is expressed as a ``ModelConfig``.
``ModelConfig.reduced()`` returns a tiny same-family config for CPU smoke
tests; the full configs are only ever lowered via ShapeDtypeStruct in the
multi-pod dry-run.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | encdec
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- attention details ---
    sliding_window: int = 0          # 0 = full attention
    local_global_period: int = 0     # gemma3: 5 local then 1 global -> period 6
    qk_norm: bool = False            # qwen3
    qkv_bias: bool = False           # qwen1.5
    rope_theta: float = 10_000.0
    rope_theta_local: float = 0.0    # gemma3 local layers
    mrope_sections: Tuple[int, ...] = ()  # qwen2-vl M-RoPE (t, h, w) splits
    learned_positions: bool = False  # whisper

    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_d_ff: int = 0
    moe_partition: str = "expert"    # expert | ffn | ep2d
    capacity_factor: float = 1.25
    norm_topk_prob: bool = True

    # --- SSM (mamba) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_version: int = 1             # 1 = mamba1 selective scan, 2 = SSD
    ssm_heads: int = 0               # mamba2 heads
    ssm_dt_rank: int = 0             # 0 -> ceil(d_model/16)

    # --- hybrid (zamba2) ---
    shared_attn_period: int = 0      # apply shared attention block every k blocks

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    max_source_positions: int = 0

    # --- misc ---
    embed_scale: float = 1.0         # gemma: sqrt(d_model)
    sandwich_norms: bool = False     # gemma3 post-attn/post-ffn norms
    act: str = "silu"                # silu | gelu
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # long-context capability flag: archs with bounded attention state can run
    # the 500k decode cell. (full-attention archs skip it; see DESIGN.md)
    supports_long_context: bool = False

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.ssm_dt_rank == 0 and self.ssm_state > 0:
            object.__setattr__(self, "ssm_dt_rank", math.ceil(self.d_model / 16))

    # ----- derived sizes -------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def param_count(self) -> int:
        """Approximate parameter count N (used for MODEL_FLOPS = 6*N*D)."""
        d, L = self.d_model, self.num_layers
        n = self.vocab_size * d  # embeddings
        if not self.tie_embeddings:
            n += self.vocab_size * d
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "hybrid", "encdec"):
            hd = self.head_dim
            qkv = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd)
            o = self.num_heads * hd * d
            attn = qkv + o
        else:
            attn = 0
        if self.family == "ssm":
            di, s = self.d_inner, self.ssm_state
            per_layer = (d * 2 * di            # in_proj (x and z)
                         + di * self.ssm_conv  # conv
                         + di * (self.ssm_dt_rank + 2 * s)  # x_proj
                         + self.ssm_dt_rank * di            # dt_proj
                         + di * s              # A_log
                         + di                  # D
                         + di * d)             # out_proj
            n += L * (per_layer + d)
            return n
        if self.is_moe:
            ffn = 3 * d * self.moe_d_ff * self.num_experts
            ffn += d * self.num_experts  # router
        else:
            mult = 3 if self.act == "silu" else 2
            ffn = mult * d * self.d_ff
        n += L * (attn + ffn + 2 * d)
        if self.family == "encdec":
            # encoder layers + cross attention in decoder
            enc_ffn = 2 * d * self.d_ff
            n += self.encoder_layers * (attn + enc_ffn + 2 * d)
            n += L * attn  # cross attention
        if self.family == "hybrid":
            # mamba2 backbone blocks
            di, s = self.d_inner, self.ssm_state
            nh = max(self.ssm_heads, 1)
            mamba = (d * 2 * di + di * self.ssm_conv + di * d
                     + di * 2 * s + nh + nh + di)
            n += L * mamba
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts count)."""
        if not self.is_moe:
            return self.param_count()
        n = self.param_count()
        dead = 3 * self.d_model * self.moe_d_ff * (
            self.num_experts - self.num_experts_per_tok) * self.num_layers
        return n - dead

    # ----- reduced config for smoke tests --------------------------------
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config: runs a forward/train step on 1 CPU core."""
        kw = dataclasses.asdict(self)
        kw.update(
            name=self.name + "-reduced",
            num_layers=min(self.num_layers, 2),
            d_model=128,
            num_heads=4 if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=32 if self.num_heads else 0,
            d_ff=256 if self.d_ff else 0,
            vocab_size=512,
            dtype="float32",
        )
        if self.local_global_period:
            kw["num_layers"] = self.local_global_period  # one full pattern
            kw["sliding_window"] = 16
        if self.sliding_window and not self.local_global_period:
            kw["sliding_window"] = 16
        if self.is_moe:
            kw.update(num_experts=4, num_experts_per_tok=2, moe_d_ff=64)
        if self.ssm_state:
            kw.update(ssm_state=8, ssm_dt_rank=8,
                      ssm_heads=4 if self.ssm_heads else 0)
        if self.family == "hybrid":
            kw.update(num_layers=6, shared_attn_period=3)
        if self.family == "encdec":
            kw.update(encoder_layers=2, max_source_positions=64)
        if self.mrope_sections:
            kw["mrope_sections"] = (8, 4, 4)  # sums to head_dim//2 = 16
        return ModelConfig(**kw)


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """How the model is laid out on the mesh + which TokenWeave features run."""
    tp_axis: str = "model"
    dp_axes: Tuple[str, ...] = ("data",)   # ("pod","data") multi-pod
    # comm_mode: how the post-matmul AllReduce + residual + RMSNorm executes
    #   vanilla   : psum -> (+residual) -> full redundant RMSNorm   (baseline)
    #   reordered : psum_scatter -> +res -> RMSNorm -> all_gather (unfused ops)
    #   fused     : psum_scatter -> single-pass fused add+norm -> all_gather
    #   ring      : ONE Pallas ring AllReduce-RMSNorm kernel (reduce-scatter,
    #               fused add+norm on the owned chunk, all-gather; falls back
    #               to `fused` where unsupported — core/fused_collectives.py)
    #   nocomm    : skip collectives entirely (perf counterfactual, wrong math)
    comm_mode: str = "fused"
    tokenweave: bool = True
    tokenweave_min_tokens: int = 512
    split_unit: int = 0                    # 0 = auto (lcm(tp, 256))
    attn_impl: str = "chunked"             # ref | chunked | pallas
    attn_block_q: int = 512
    attn_block_kv: int = 1024
    remat: bool = True
    scan_layers: bool = True
    use_pallas_norm: bool = False          # pallas fused rmsnorm (TPU target)
    # §Perf: pin collectives to bf16 (optimization_barrier stops XLA's
    # excess-precision pass from hoisting downstream f32 casts above the
    # RS/AG, which doubles wire bytes)
    bf16_wire: bool = False
    seq_shard_kv: bool = False             # context-parallel KV over dp axis
    grad_compression: str = "none"         # none | int8
    moe_ep_axis: str = "data"              # a2a axis for ep2d partitioning
    # per-site overlap policy (core/policy.OverlapPolicy, DESIGN.md §14);
    # None = degenerate global-threshold policy (token-identical to the
    # legacy split_decision path). Typed Any to avoid a configs->core
    # import; policies are frozen/hashable so the config stays hashable.
    overlap_policy: "object | None" = None

    @property
    def axes(self) -> Tuple[str, ...]:
        return tuple(self.dp_axes) + (self.tp_axis,)

    def split_unit_for(self, tp: int) -> int:
        if self.split_unit:
            u = self.split_unit
        else:
            u = 256
        # every split must be divisible by tp for tiled psum_scatter
        return math.lcm(u, max(tp, 1))
