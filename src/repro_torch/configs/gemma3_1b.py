"""gemma3-1b [dense]: 26L d=1152 4H (GQA kv=1, head_dim=256) d_ff=6912
vocab=262144; 5 local (sw=512) : 1 global pattern; dual rope theta; qk-norm,
sandwich norms, GEGLU, tied+scaled embeddings. [hf:google/gemma-3-1b-pt]"""
import math

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense",
    num_layers=26, d_model=1152, num_heads=4, num_kv_heads=1, head_dim=256,
    d_ff=6912, vocab_size=262144,
    sliding_window=512, local_global_period=6,
    rope_theta=1_000_000.0, rope_theta_local=10_000.0,
    qk_norm=True, sandwich_norms=True, act="geglu",
    embed_scale=math.sqrt(1152.0), tie_embeddings=True,
    supports_long_context=True,
)
