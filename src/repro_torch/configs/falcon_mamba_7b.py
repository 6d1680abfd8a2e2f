"""Falcon-Mamba-7B — attention-free Mamba1. [arXiv:2410.05355]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", arch_type="ssm",
    num_layers=64, d_model=4096, num_heads=0, num_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=65024,
    ssm_state=16, ssm_version=1, ssm_expand=2, ssm_conv=4,
    source="arXiv:2410.05355",
)

SMOKE_CONFIG = CONFIG.replace(
    name="falcon-mamba-7b-smoke", num_layers=2, d_model=256, vocab_size=1024,
    ssm_state=8,
)
