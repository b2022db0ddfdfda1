"""InternVL2-26B — VLM: InternViT (stub) + InternLM2-20B decoder
[arXiv:2404.16821]. The vision encoder is a STUB: a batch supplies
1024-d patch embeddings (``batch["patches"]``); a 2-layer projector maps
them into the LM (the allowed carve-out). num_prefix_tokens patch slots lead the sequence."""
from repro_torch.configs.base import ArchConfig, replace

CONFIG = ArchConfig(
    name="internvl2-26b", family="vlm",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=92553,
    frontend="vision", num_prefix_tokens=1024,
    rope_theta=1_000_000.0,
    source="arXiv:2404.16821",
)


def reduced() -> ArchConfig:
    return replace(CONFIG, name="internvl2-reduced", num_layers=2,
                   d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
                   d_ff=512, vocab_size=512, num_prefix_tokens=16)
