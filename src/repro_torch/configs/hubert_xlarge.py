"""HuBERT-XLarge — encoder-only audio transformer [arXiv:2106.07447].
The conv feature extractor / mel frontend is a STUB: a batch supplies
precomputed 512-d frame embeddings (``batch["frames"]``), which a learned
projection maps into d_model. Encoder-only => no decode step."""
from repro_torch.configs.base import ArchConfig, replace

CONFIG = ArchConfig(
    name="hubert-xlarge", family="encoder",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16, head_dim=80,
    d_ff=5120, vocab_size=504,
    is_encoder_only=True, frontend="audio",
    source="arXiv:2106.07447",
)


def reduced() -> ArchConfig:
    return replace(CONFIG, name="hubert-reduced", num_layers=2,
                   d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
                   d_ff=512, vocab_size=64)
