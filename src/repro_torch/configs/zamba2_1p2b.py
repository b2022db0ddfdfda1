"""Zamba2-1.2B — hybrid Mamba2 backbone + shared attention block
[arXiv:2411.15242]. The shared attention uses a 4096 sliding window so the
hybrid stays sub-quadratic at long_500k."""
from repro_torch.configs.base import ArchConfig, replace

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid_zamba2",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_heads=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
    shared_attn_every=6, sliding_window=4096,
    source="arXiv:2411.15242",
)


def reduced() -> ArchConfig:
    return replace(CONFIG, name="zamba2-reduced", num_layers=2,
                   d_model=128, num_heads=2, num_kv_heads=2, head_dim=64,
                   d_ff=256, vocab_size=512,
                   ssm_state=16, ssm_heads=4, ssm_head_dim=64, ssm_chunk=32,
                   shared_attn_every=2, sliding_window=64)
