"""falcon-mamba-7b [ssm]: 64L d=4096 attention-free Mamba-1, ssm_state=16,
d_inner=8192, dt_rank=256, vocab=65024. [arXiv:2410.05355]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    num_layers=64, d_model=4096, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=65024,
    ssm_state=16, ssm_expand=2, ssm_version=1, ssm_conv=4,
    supports_long_context=True,
)
