"""MiniCPM-2B — dense llama-like decoder trained with the WSD schedule
[arXiv:2404.06395]. Tied embeddings; vocab 122753 is odd, and so is the
reduced config's 513 (padded only where ``vocab_pad_to`` asks)."""
from repro_torch.configs.base import ArchConfig, replace

CONFIG = ArchConfig(
    name="minicpm-2b", family="dense",
    num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36, head_dim=64,
    d_ff=5760, vocab_size=122753, tie_embeddings=True,
    source="arXiv:2404.06395",
)


def reduced() -> ArchConfig:
    return replace(CONFIG, name="minicpm-reduced", num_layers=2,
                   d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
                   d_ff=512, vocab_size=513)  # odd vocab on purpose (fallback path)
