"""The paper's CNN feature learner (LeNet family, Fig. 1/3) — the port's
counterpart of ``repro.models.cnn``.

Architecture string such as 6c-2s-12c-2s (Table 4/5) or 3c-2s-9c-2s
(Table 2/3): conv (valid, k=5) -> ReLU -> mean-pool (scale 2) per stage.
The flattened last pooled map, in NHWC order, is the ELM hidden matrix H
(Fig. 2); the optimal-tanh activation is applied in ``core.elm``.

Parameters are a plain tree in the reference's layout:
``{"stages": ({"w": (k, k, c_in, c_out), "b": (c_out,)}, ...)}``. The
member-stacked tree of the stacked Map path carries a leading member dim
on every leaf. Convolutions go through ``kernels.conv2d.ops`` (hand kernel
on CUDA, plain version on the CPU).
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.kernels.conv2d import ops as conv_ops


def feature_dim(cfg) -> int:
    n, ch = cfg.image_size, cfg.image_channels
    for c in cfg.cnn_channels:
        n = (n - cfg.cnn_kernel + 1) // cfg.cnn_pool
        ch = c
    return n * n * ch


def init_params(cfg, generator: torch.Generator, device="cuda"):
    """Kernels W: (k, k, c_in, c_out) ~ N(0, 2/fan_in) and zero biases per
    stage — the reference's distribution (``repro.models.cnn.init_params``)
    from a ``torch.Generator``, so the numbers differ. The weights are drawn
    on the generator's device (a CPU generator gives the same weights
    whatever ``device`` they are then moved to). The paper initialises all
    k machines with the SAME weights (Alg. 2 line 3): callers reuse one
    init across members."""
    dev = resolve_device(device)
    params = []
    ch_in = cfg.image_channels
    for ch_out in cfg.cnn_channels:
        fan_in = cfg.cnn_kernel * cfg.cnn_kernel * ch_in
        w = torch.randn((cfg.cnn_kernel, cfg.cnn_kernel, ch_in, ch_out),
                        generator=generator, dtype=torch.float32,
                        device=generator.device) * (2.0 / fan_in) ** 0.5
        params.append({"w": w.to(dev),
                       "b": torch.zeros((ch_out,), dtype=torch.float32,
                                        device=dev)})
        ch_in = ch_out
    return {"stages": tuple(params)}


def _mean_pool(x, s: int):
    """Non-overlapping s x s mean-pool over (H, W) of (..., H, W, C). The
    window is summed in a fixed order, so a row's result does not depend on
    the batch it rides in."""
    if x.shape[-3] % s or x.shape[-2] % s:
        raise ValueError(f"a {s}x{s} pool does not tile a "
                         f"{x.shape[-3]}x{x.shape[-2]} map")
    acc = None
    for di in range(s):
        for dj in range(s):
            part = x[..., di::s, dj::s, :]
            acc = part if acc is None else acc + part
    return acc / float(s * s)


class _AddBias(torch.autograd.Function):
    """x (k, B, H, W, C) + b (k, C), member i's bias on member i's maps. Its
    gradient sums dY over each member's pixels one member at a time: a
    reduction over all k at once may split the sum by k, and SGD amplifies
    one rounding, so a member's bias gradient is the same bits for any k."""

    @staticmethod
    def forward(ctx, x, b):
        return x + b[:, None, None, None, :]

    @staticmethod
    def backward(ctx, dy):
        db = torch.stack([dy[i].sum(dim=(0, 1, 2))
                          for i in range(dy.shape[0])])
        return dy, db


def features_members(cfg, params_k, images_k):
    """Member-batched features: params_k leaves carry a leading member dim
    k, images_k is (k, B, H, W) or (k, B, H, W, C) — member i's images
    through member i's CNN. Returns flat H (k, B, F) in NHWC order."""
    x = images_k if images_k.dim() == 5 else images_k[..., None]
    x = x.float().contiguous()
    for st in params_k["stages"]:
        x = conv_ops.conv2d_valid(x, st["w"].contiguous())
        b = st["b"]
        x = torch.relu(_AddBias.apply(x, b) if torch.is_grad_enabled()
                       and (x.requires_grad or b.requires_grad)
                       else x + b[:, None, None, None, :])
        x = _mean_pool(x, cfg.cnn_pool).contiguous()
    return x.reshape(x.shape[0], x.shape[1], -1)


def features(cfg, params, images):
    """images: (B, H, W) or (B, H, W, C) in [0,1]. Returns flat H (B, F) —
    the one-member case of ``features_members``."""
    params_k = {"stages": tuple({name: a[None] for name, a in st.items()}
                                for st in params["stages"])}
    return features_members(cfg, params_k, images[None])[0]
