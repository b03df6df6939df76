"""olmoe-1b-7b [moe]: 16L d=2048 16H d_ff(expert)=1024 vocab=50304,
64 experts top-8; expert-parallel over the model axis (combine = the layer's
TP AllReduce -> TokenWeave fused kernel applies unchanged). [arXiv:2409.02060]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=1024, vocab_size=50304,
    num_experts=64, num_experts_per_tok=8, moe_d_ff=1024,
    moe_partition="expert", norm_topk_prob=False,
    rope_theta=10_000.0,
)
