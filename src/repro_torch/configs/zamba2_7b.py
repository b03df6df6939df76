"""zamba2-7b [hybrid]: 81 Mamba-2 blocks d=3584 + shared 2d-wide attention
(32H) every 6 blocks w/ per-invocation LoRA; ssm_state=64, d_inner=7168,
112 ssm heads (dh=64). [arXiv:2411.15242]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
    d_ff=14336, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_version=2, ssm_heads=112, ssm_conv=4,
    shared_attn_period=6,
    rope_theta=10_000.0,
    supports_long_context=True,
)
