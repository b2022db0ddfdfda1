"""Qwen3-MoE-235B-A22B — 128-expert top-8 MoE decoder, GQA kv=4, qk-norm
[hf:Qwen/Qwen3-30B-A3B scaled per assignment]."""
from repro_torch.configs.base import ArchConfig, replace

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4, head_dim=128,
    d_ff=1536, moe_d_ff=1536, vocab_size=151936,
    num_experts=128, experts_per_token=8, qk_norm=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-30B-A3B",
)


def reduced() -> ArchConfig:
    return replace(CONFIG, name="qwen3-moe-reduced", num_layers=2,
                   d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
                   d_ff=256, moe_d_ff=256, vocab_size=512,
                   num_experts=4, experts_per_token=2)
