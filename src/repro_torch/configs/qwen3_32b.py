"""Qwen3-32B — dense GQA decoder with qk-norm [hf:Qwen/Qwen3-8B family]."""
from repro_torch.configs.base import ArchConfig, replace

CONFIG = ArchConfig(
    name="qwen3-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=25600, vocab_size=151936, qk_norm=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B",
)


def reduced() -> ArchConfig:
    return replace(CONFIG, name="qwen3-32b-reduced", num_layers=2,
                   d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
                   d_ff=512, vocab_size=512)
