"""Chameleon-34B — early-fusion VLM, VQ image tokens share the text vocab.
The VQ image tokenizer is the stubbed frontend: inputs are interleaved
text+image token ids. [arXiv:2405.09818]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", arch_type="vlm",
    num_layers=48, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=22016, vocab_size=65536, rope_theta=10_000.0,
    modality="vq_image+text",
    source="arXiv:2405.09818",
)

SMOKE_CONFIG = CONFIG.replace(
    name="chameleon-34b-smoke", num_layers=2, d_model=256, num_heads=8,
    num_kv_heads=2, head_dim=32, d_ff=512, vocab_size=1024,
)
