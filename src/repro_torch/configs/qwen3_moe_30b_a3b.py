"""Qwen3-30B-A3B — MoE, 128 experts top-8, GQA. [hf:Qwen/Qwen3-30B-A3B]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", arch_type="moe",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=4, head_dim=128,
    d_ff=768, vocab_size=151936, rope_theta=1_000_000.0,
    num_experts=128, experts_per_token=8,
    source="hf:Qwen/Qwen3-30B-A3B",
)

SMOKE_CONFIG = CONFIG.replace(
    name="qwen3-moe-30b-a3b-smoke", num_layers=2, d_model=256, num_heads=8,
    num_kv_heads=2, head_dim=32, d_ff=128, vocab_size=1024,
    num_experts=4, experts_per_token=2,
)
