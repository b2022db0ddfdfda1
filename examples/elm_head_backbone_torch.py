"""ELM readout on a modern backbone, on the PyTorch/CUDA port — the
paper's CNN-ELM integration generalised; the port's counterpart of
``examples/elm_head_backbone.py``.

A reduced HuBERT-style encoder plays the CNN's role (feature learner); the
ELM head is fit in closed form from E²LM sufficient statistics accumulated
over batches (Map), then the backbone is fine-tuned by back-propagating the
ELM least-squares error (Algorithm 2 lines 13-14) — no iterative head
training at any point. On the card the encoder's attention runs through
the swa_attention kernel's non-causal mode, forward and backward, its
norms through rmsnorm and rmsnorm_bwd, and the statistics through
elm_stats.

  PYTHONPATH=src python examples/elm_head_backbone_torch.py --device cpu
  PYTHONPATH=src python examples/elm_head_backbone_torch.py    # the card
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_reduced_config
from repro_torch.core import elm_head
from repro_torch.models import api


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, the plain PyTorch path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_reduced_config("hubert_xlarge")
    params = api.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             device=dev)

    # synthetic frame-classification task: 8 latent classes, frames carry a
    # class-dependent bias the encoder can pick up
    rng = np.random.default_rng(0)
    C = 8
    class_emb = rng.normal(size=(C, 512)).astype(np.float32)

    def make_batch(seed):
        r = np.random.default_rng(seed)
        y = r.integers(0, C, size=(4, 64))
        frames = class_emb[y] + 0.3 * r.normal(size=(4, 64, 512))
        return {"frames": torch.tensor(frames, dtype=torch.bfloat16,
                                       device=dev),
                "targets": torch.tensor(y, device=dev)}

    def feature_fn(p, b):
        return api.hidden_states(cfg, p, b)

    def fit(params):
        stats = None
        for i in range(8):
            stats = elm_head.accumulate_stats(feature_fn, params,
                                              make_batch(i), C, stats)
        return elm_head.solve(stats, lam=100.0)

    def acc(params, beta, seed):
        b = make_batch(seed)
        scores = elm_head.predict(feature_fn, params, beta, b)
        pred = torch.argmax(scores, -1).reshape(b["targets"].shape)
        return float((pred == b["targets"]).float().mean())

    # ---- Map: accumulate U, V over batches, then the closed-form head ----
    beta = fit(params)
    before = acc(params, beta, 999)
    print(f"ELM head, closed form (no head SGD): acc={before:.3f}")

    # ---- Alg. 2 lines 13-14: fine-tune the backbone on the ELM error ----
    losses = []
    for step in range(5):
        params, loss = elm_head.finetune_step(
            feature_fn, params, beta, make_batch(100 + step), C, lr=1e-3)
        losses.append(float(loss))
        print(f"  finetune step {step}: elm loss={losses[-1]:.4f}")

    # re-solve the head after fine-tuning (the paper's per-epoch re-solve)
    beta = fit(params)
    after = acc(params, beta, 999)
    print(f"after backbone fine-tune + re-solve:  acc={after:.3f}")
    return {"acc_before": before, "acc_after": after, "losses": losses}


if __name__ == "__main__":
    main()
