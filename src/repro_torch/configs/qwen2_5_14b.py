"""Qwen2.5-14B — dense, GQA, QKV bias. [hf:Qwen/Qwen2.5-0.5B family card]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b", arch_type="dense",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=13824, vocab_size=152064, qkv_bias=True, rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen2.5-0.5B (family); Qwen2.5 technical report",
)

SMOKE_CONFIG = CONFIG.replace(
    name="qwen2.5-14b-smoke", num_layers=2, d_model=256, num_heads=8,
    num_kv_heads=2, head_dim=32, d_ff=512, vocab_size=1024,
)
