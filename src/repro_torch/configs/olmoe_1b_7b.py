"""OLMoE-1B-7B — 64-expert top-8 MoE decoder [arXiv:2409.02060]."""
from repro_torch.configs.base import ArchConfig, replace

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=1024, moe_d_ff=1024, vocab_size=50304,
    num_experts=64, experts_per_token=8,
    source="arXiv:2409.02060",
)


def reduced() -> ArchConfig:
    return replace(CONFIG, name="olmoe-reduced", num_layers=2,
                   d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
                   d_ff=256, moe_d_ff=256, vocab_size=512,
                   num_experts=4, experts_per_token=2)
