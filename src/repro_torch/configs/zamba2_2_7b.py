"""Zamba2-2.7B — hybrid Mamba2 backbone + one SHARED attention block applied
periodically (weight sharing across applications). [arXiv:2411.15242]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", arch_type="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32, head_dim=80,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_version=2, ssm_expand=2, ssm_heads=80,  # d_inner=5120, head 64
    shared_attn_every=6,
    source="arXiv:2411.15242",
)

SMOKE_CONFIG = CONFIG.replace(
    name="zamba2-2.7b-smoke", num_layers=2, d_model=256, num_heads=8,
    num_kv_heads=8, head_dim=32, d_ff=512, vocab_size=1024,
    ssm_state=16, ssm_heads=8, shared_attn_every=1,
)
