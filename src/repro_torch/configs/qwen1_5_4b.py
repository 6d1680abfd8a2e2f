"""Qwen1.5-4B — dense, MHA (kv=heads), QKV bias. [hf:Qwen/Qwen1.5-0.5B family]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", arch_type="dense",
    num_layers=40, d_model=2560, num_heads=20, num_kv_heads=20, head_dim=128,
    d_ff=6912, vocab_size=151936, qkv_bias=True, rope_theta=5_000_000.0,
    source="hf:Qwen/Qwen1.5-0.5B (family)",
)

SMOKE_CONFIG = CONFIG.replace(
    name="qwen1.5-4b-smoke", num_layers=2, d_model=256, num_heads=8,
    num_kv_heads=8, head_dim=32, d_ff=512, vocab_size=1024,
)
