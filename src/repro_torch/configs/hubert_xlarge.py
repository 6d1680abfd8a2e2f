"""HuBERT-XLarge — encoder-only audio transformer (w2v2 arch). The conv
feature extractor is a stubbed frontend: inputs are precomputed frame
embeddings. [arXiv:2106.07447]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", arch_type="audio",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16, head_dim=80,
    d_ff=5120, vocab_size=504,
    is_encoder=True, modality="audio_frames",
    source="arXiv:2106.07447",
)

SMOKE_CONFIG = CONFIG.replace(
    name="hubert-xlarge-smoke", num_layers=2, d_model=256, num_heads=8,
    num_kv_heads=8, head_dim=32, d_ff=512, vocab_size=64,
)
