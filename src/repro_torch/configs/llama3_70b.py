"""llama-3.3-70b (paper model): 80L d=8192 64H (GQA kv=8) d_ff=28672
vocab=128256. [arXiv:2407.21783]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.3-70b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=128256,
    rope_theta=500_000.0,
)
