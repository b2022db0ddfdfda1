"""InternLM2-20B — dense GQA decoder [arXiv:2403.17297]."""
from repro_torch.configs.base import ArchConfig, replace

CONFIG = ArchConfig(
    name="internlm2-20b", family="dense",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=92544,
    rope_theta=1_000_000.0,
    source="arXiv:2403.17297",
)


def reduced() -> ArchConfig:
    return replace(CONFIG, name="internlm2-20b-reduced", num_layers=2,
                   d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
                   d_ff=512, vocab_size=512)
