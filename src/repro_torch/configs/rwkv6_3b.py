"""RWKV6-3B "Finch" — attention-free, data-dependent decay
[arXiv:2404.05892]. Heads = d_model/64 = 40. Runs long_500k natively
(O(1)-in-seq recurrent state)."""
from repro_torch.configs.base import ArchConfig, replace

CONFIG = ArchConfig(
    name="rwkv6-3b", family="ssm_rwkv6",
    num_layers=32, d_model=2560, d_ff=8960, vocab_size=65536,
    ssm_chunk=32,
    source="arXiv:2404.05892",
)


def reduced() -> ArchConfig:
    return replace(CONFIG, name="rwkv6-reduced", num_layers=2,
                   d_model=128, d_ff=256, vocab_size=512, ssm_chunk=16)
