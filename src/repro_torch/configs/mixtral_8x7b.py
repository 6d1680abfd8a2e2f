"""Mixtral-8x7B — MoE 8 experts top-2, GQA, sliding-window attention.
[arXiv:2401.04088]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", arch_type="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000, rope_theta=1_000_000.0,
    num_experts=8, experts_per_token=2,
    attn_variant="swa", sliding_window=4096,
    source="arXiv:2401.04088",
)

SMOKE_CONFIG = CONFIG.replace(
    name="mixtral-8x7b-smoke", num_layers=2, d_model=256, num_heads=8,
    num_kv_heads=2, head_dim=32, d_ff=128, vocab_size=1024,
    num_experts=4, experts_per_token=2, sliding_window=64,
)
