"""Configuration system — the port's copy of ``repro.configs.base``.

Each architecture has a module ``repro_torch/configs/<id>.py`` exporting
``CONFIG`` and ``reduced()``. The port carries the paper's two CNN-ELM
architectures and the LM zoo: the transformer families (dense, MoE,
encoder, VLM) and the recurrent ones (RWKV6, the Zamba2 hybrid).

Configs are frozen dataclasses so they are hashable and can be shared
between members and threads as static data.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class ArchConfig:
    """A single architecture description (backbone + head).

    ``family`` selects the model implementation in ``repro.models``:
      dense | moe | ssm_mamba2 | ssm_rwkv6 | hybrid_zamba2 | encoder | vlm | cnn
    """

    name: str
    family: str
    # transformer-ish core
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    qk_norm: bool = False
    # §Perf: pad the vocab (embedding rows / logits) up to a multiple of
    # this value (0 = off). Padded logits are masked to -1e30 (softmax
    # prob exactly 0 in f32 ⇒ padded-row grads exactly 0), so semantics
    # are EXACT — but an odd vocab (minicpm: 122753) becomes shardable
    # over the model axis, cutting the replicated logits buffer.
    vocab_pad_to: int = 0
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0          # per-expert hidden size (d_ff keeps dense value if any)
    router_aux_coef: float = 0.01
    moe_capacity_factor: float = 1.25
    # §Perf knob: sharding constraint on expert outputs before the combine
    # gather — "expert" (baseline), "batch" (planned all-gather), "none"
    moe_combine_sharding: str = "expert"
    # SSM (mamba2 / rwkv6 / zamba2)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 0
    ssm_expand: int = 2
    ssm_chunk: int = 128
    # rwkv execution mode: "scan" (exact recurrence, paper-faithful baseline)
    # or "chunked" (MXU-friendly masked-matmul form — the TPU production path)
    rwkv_mode: str = "chunked"
    # §Perf: pad the RWKV head count up to this multiple (0 = off). Padded
    # projection columns are zero-initialised and provably stay zero under
    # gradient descent (their grads vanish identically), so semantics are
    # EXACT — but the 40-head reshape becomes 48 heads, divisible by the
    # model axis, which removes per-layer all-gather resharding.
    rwkv_head_pad_to: int = 0
    # zamba2 hybrid: apply the single shared attention block every k-th layer
    shared_attn_every: int = 0
    # attention variants
    sliding_window: int = 0     # 0 = full attention
    # encoder-only / multimodal stubs
    is_encoder_only: bool = False
    frontend: str = ""          # "audio" | "vision" | "" — stub embedding provider
    num_prefix_tokens: int = 0  # VLM: number of patch-embedding prefix tokens
    # paper CNN-ELM family
    cnn_channels: Tuple[int, ...] = ()
    cnn_kernel: int = 5
    cnn_pool: int = 2
    image_size: int = 28
    image_channels: int = 1
    num_classes: int = 0
    # ELM head
    elm_lambda: float = 1e-2
    # dry-run cost accounting: unroll the layer loop so XLA cost_analysis
    # counts every layer (scan/while bodies are counted ONCE by XLA —
    # verified empirically; see launch/dryrun.py). Runtime paths keep scan.
    unroll_layers: bool = False
    # citation for the assignment table
    source: str = ""

    def __post_init__(self):
        if self.num_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        v, m = self.vocab_size, self.vocab_pad_to
        return v if not m or v % m == 0 else v + m - v % m

    # ---- derived quantities -------------------------------------------------
    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS)."""
        c = self
        if c.family == "cnn":
            n, ch_in, total = c.image_size, c.image_channels, 0
            for ch_out in c.cnn_channels:
                total += ch_out * ch_in * c.cnn_kernel * c.cnn_kernel + ch_out
                ch_in = ch_out
                n = (n - c.cnn_kernel + 1) // c.cnn_pool
            total += (n * n * ch_in) * c.num_classes  # ELM beta
            return total
        emb = c.vocab_size * c.d_model
        total = emb if c.tie_embeddings or c.is_encoder_only else 2 * emb
        per_layer = 0
        if c.family in ("dense", "moe", "encoder", "vlm"):
            attn = c.d_model * (c.q_dim + 2 * c.kv_dim) + c.q_dim * c.d_model
            per_layer += attn
            if c.family == "moe":
                ff = c.moe_d_ff or c.d_ff
                per_layer += c.num_experts * 3 * c.d_model * ff
                per_layer += c.d_model * c.num_experts  # router
            else:
                per_layer += 3 * c.d_model * c.d_ff
            per_layer += 2 * c.d_model  # norms
        elif c.family == "ssm_mamba2":
            d_in = c.ssm_expand * c.d_model
            per_layer += c.d_model * (2 * d_in + 2 * c.ssm_heads * c.ssm_state)
            per_layer += d_in * c.d_model + 3 * c.d_model + c.d_model * c.d_ff * 3
        elif c.family == "ssm_rwkv6":
            d = c.d_model
            per_layer += 4 * d * d + d * d  # r,k,v,g,o (time mixing)
            per_layer += 2 * d * c.d_ff  # channel mixing (rwkv ffn)
            per_layer += 2 * d
        elif c.family == "hybrid_zamba2":
            # mamba mixer + norm only; the MLP lives in the (single) shared
            # block — that is what makes zamba2 1.2B (see models/zamba2.py)
            d_in = c.ssm_expand * c.d_model
            per_layer += c.d_model * (2 * d_in + 2 * c.ssm_state) + d_in * c.d_model
            per_layer += 2 * c.ssm_heads + d_in + c.d_model
        total += c.num_layers * per_layer
        if c.family == "hybrid_zamba2":
            total += c.d_model * (c.q_dim + 2 * c.kv_dim) + c.q_dim * c.d_model
            total += 3 * c.d_model * c.d_ff  # shared MLP, once
        return total

    def active_param_count(self) -> int:
        """Active params per token (== param_count except MoE)."""
        if self.family != "moe":
            return self.param_count()
        c = self
        ff = c.moe_d_ff or c.d_ff
        inactive = c.num_layers * (c.num_experts - c.experts_per_token) * 3 * c.d_model * ff
        return self.param_count() - inactive


@dataclass(frozen=True)
class InputShape:
    """One input shape of the dry run: ``seq_len`` tokens (or frames) of
    ``global_batch`` sequences, for a step of ``kind``."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = [
    # the paper's own CNN-ELM architectures
    "cnn_elm_6c12c",
    "cnn_elm_3c9c",
    # the LM zoo's transformer families (``models/transformer.py``)
    "internlm2_20b",
    "qwen3_moe_235b_a22b",
    "olmoe_1b_7b",
    "qwen3_32b",
    "minicpm_2b",
    "qwen3_8b",
    "hubert_xlarge",
    "internvl2_26b",
    # the recurrent families (``models/rwkv6.py``, ``models/zamba2.py``)
    "zamba2_1p2b",
    "rwkv6_3b",
]

_ALIAS = {a.replace("_", "-"): a for a in ARCH_IDS}
_ALIAS.update({"zamba2-1.2b": "zamba2_1p2b"})


def get_config(arch: str) -> ArchConfig:
    arch = _ALIAS.get(arch, arch).replace("-", "_").replace(".", "p")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.CONFIG


def get_reduced_config(arch: str) -> ArchConfig:
    arch = _ALIAS.get(arch, arch).replace("-", "_").replace(".", "p")
    mod = importlib.import_module(f"repro_torch.configs.{arch}")
    return mod.reduced()


def replace(cfg: ArchConfig, **kw) -> ArchConfig:
    return dataclasses.replace(cfg, **kw)


def supported_shapes(cfg: ArchConfig):
    """Which input shapes apply to this architecture (False: a skip
    note)."""
    out = {}
    for name, shp in INPUT_SHAPES.items():
        if cfg.family == "cnn":
            out[name] = name == "train_4k"  # CNN-ELM only trains
            continue
        if shp.kind == "decode" and cfg.is_encoder_only:
            out[name] = False  # encoder-only: no autoregressive decode
            continue
        out[name] = True
    return out
