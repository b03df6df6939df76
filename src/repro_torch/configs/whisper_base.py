"""whisper-base [audio enc-dec]: 6L enc + 6L dec, d=512 8H d_ff=2048
vocab=51865; conv frontend STUBBED (input_specs supplies frame embeddings);
learned positions (decoder table grown for long decode cells — documented
deviation). [arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    num_layers=6, encoder_layers=6, d_model=512, num_heads=8, num_kv_heads=8,
    head_dim=64, d_ff=2048, vocab_size=51865,
    act="gelu", learned_positions=True, max_source_positions=1500,
)
