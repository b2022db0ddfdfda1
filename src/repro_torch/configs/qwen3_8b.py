"""Qwen3-8B — dense GQA decoder with qk-norm [hf:Qwen/Qwen3-8B]."""
from repro_torch.configs.base import ArchConfig, replace

CONFIG = ArchConfig(
    name="qwen3-8b", family="dense",
    num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=12288, vocab_size=151936, qk_norm=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B",
)


def reduced() -> ArchConfig:
    return replace(CONFIG, name="qwen3-8b-reduced", num_layers=2,
                   d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
                   d_ff=512, vocab_size=512)
