"""mixtral-8x22b (paper model) [moe]: 56L d=6144 48H (GQA kv=8)
d_ff(expert)=16384, 8 experts top-2 vocab=32768; 'ffn' partitioning (every
shard holds a d_ff slice of every expert — vLLM-style TP MoE, E < tp).
[arXiv:2401.04088]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=32768,
    num_experts=8, num_experts_per_tok=2, moe_d_ff=16384,
    moe_partition="ffn",
    rope_theta=1_000_000.0,
)
