"""qwen3-moe-235b-a22b [moe]: 94L d=4096 64H (GQA kv=4) d_ff(expert)=1536
vocab=151936, 128 experts top-8; ep2d partitioning (experts over data x d_ff
over model) — the only layout that fits 235B on v5e-256; dispatch a2a is the
DeepSeek-style comm the paper contrasts with. [hf:Qwen/Qwen3 family]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4, head_dim=128,
    d_ff=1536, vocab_size=151936,
    num_experts=128, num_experts_per_tok=8, moe_d_ff=1536,
    moe_partition="ep2d", qk_norm=True,
    rope_theta=1_000_000.0,
)
