"""InternLM2-1.8B — dense, GQA. [arXiv:2403.17297]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b", arch_type="dense",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=92544, rope_theta=1_000_000.0,
    source="arXiv:2403.17297",
)

SMOKE_CONFIG = CONFIG.replace(
    name="internlm2-1.8b-smoke", num_layers=2, d_model=256, num_heads=8,
    num_kv_heads=4, head_dim=32, d_ff=512, vocab_size=1024,
)
