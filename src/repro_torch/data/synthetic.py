"""Synthetic stand-ins for the paper's datasets — the port's copy of
``repro.data.synthetic`` (numpy only; same seed, same images).

Structure mirrors the paper exactly:

* ``make_extended_mnist`` — 10 glyph classes, 28x28 grayscale; the base set is
  extended 3x with the paper's three noise models (gaussian, salt&pepper,
  poisson) so each "partition-sized block" has the *same* distribution — the
  property the paper credits for averaging working on extended MNIST.
* ``make_not_mnist`` — 20 classes (10 numeric + 10 alphabet) with deliberately
  overlapping template pairs (1<->I, 4<->A, per the paper's "look-alike"
  remark) plus a fraction of "foolish" label-noise images. Class blocks are
  generated contiguous-by-class so a naive contiguous partition is *non-IID*
  — reproducing the paper's not-MNIST failure mode.

Images are procedural glyphs: per-class fixed stroke templates + random
affine jitter, rendered at 28x28. Deterministic given seed.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

IMG = 28

# ---------------------------------------------------------------------------
# glyph templates: list of strokes; each stroke is ((r0,c0),(r1,c1)) on a 7x7
# design grid, scaled to 28x28 at render time.
# ---------------------------------------------------------------------------
_G = {
    "0": [((1, 2), (1, 4)), ((1, 4), (5, 4)), ((5, 4), (5, 2)), ((5, 2), (1, 2))],
    "1": [((1, 3), (5, 3)), ((1, 3), (2, 2))],
    "2": [((1, 2), (1, 4)), ((1, 4), (3, 4)), ((3, 4), (3, 2)), ((3, 2), (5, 2)), ((5, 2), (5, 4))],
    "3": [((1, 2), (1, 4)), ((3, 2), (3, 4)), ((5, 2), (5, 4)), ((1, 4), (5, 4))],
    "4": [((1, 2), (3, 2)), ((3, 2), (3, 4)), ((1, 4), (5, 4))],
    "5": [((1, 4), (1, 2)), ((1, 2), (3, 2)), ((3, 2), (3, 4)), ((3, 4), (5, 4)), ((5, 4), (5, 2))],
    "6": [((1, 4), (1, 2)), ((1, 2), (5, 2)), ((5, 2), (5, 4)), ((5, 4), (3, 4)), ((3, 4), (3, 2))],
    "7": [((1, 2), (1, 4)), ((1, 4), (5, 2))],
    "8": [((1, 2), (1, 4)), ((1, 4), (5, 4)), ((5, 4), (5, 2)), ((5, 2), (1, 2)), ((3, 2), (3, 4))],
    "9": [((3, 4), (3, 2)), ((3, 2), (1, 2)), ((1, 2), (1, 4)), ((1, 4), (5, 4))],
    # alphabet A-J; A intentionally echoes 4, I intentionally echoes 1
    "A": [((5, 2), (1, 3)), ((1, 3), (5, 4)), ((3, 2), (3, 4))],
    "B": [((1, 2), (5, 2)), ((1, 2), (1, 4)), ((3, 2), (3, 4)), ((5, 2), (5, 4)), ((1, 4), (3, 4)), ((3, 4), (5, 4))],
    "C": [((1, 4), (1, 2)), ((1, 2), (5, 2)), ((5, 2), (5, 4))],
    "D": [((1, 2), (5, 2)), ((1, 2), (1, 3)), ((5, 2), (5, 3)), ((1, 3), (3, 4)), ((5, 3), (3, 4))],
    "E": [((1, 4), (1, 2)), ((1, 2), (5, 2)), ((5, 2), (5, 4)), ((3, 2), (3, 3))],
    "F": [((1, 4), (1, 2)), ((1, 2), (5, 2)), ((3, 2), (3, 3))],
    "G": [((1, 4), (1, 2)), ((1, 2), (5, 2)), ((5, 2), (5, 4)), ((5, 4), (3, 4)), ((3, 4), (3, 3))],
    "H": [((1, 2), (5, 2)), ((1, 4), (5, 4)), ((3, 2), (3, 4))],
    "I": [((1, 3), (5, 3)), ((1, 2), (1, 4)), ((5, 2), (5, 4))],
    "J": [((1, 2), (1, 4)), ((1, 3), (5, 3)), ((5, 3), (5, 2)), ((5, 2), (4, 2))],
}

NUMERIC = list("0123456789")
ALPHA = list("ABCDEFGHIJ")


def _render(glyph: str, rng: np.random.Generator) -> np.ndarray:
    """Rasterise a glyph with random affine jitter onto a 28x28 canvas."""
    img = np.zeros((IMG, IMG), np.float32)
    scale = 4.0 * (0.8 + 0.4 * rng.random())
    theta = (rng.random() - 0.5) * 0.5
    shear = (rng.random() - 0.5) * 0.3
    dx, dy = rng.integers(-2, 3, size=2)
    ct, st = np.cos(theta), np.sin(theta)
    for (r0, c0), (r1, c1) in _G[glyph]:
        n = 24
        rr = np.linspace(r0, r1, n) - 3.0
        cc = np.linspace(c0, c1, n) - 3.0
        cc = cc + shear * rr
        r = ct * rr - st * cc
        c = st * rr + ct * cc
        ri = np.clip((r * scale + IMG / 2 + dy), 0, IMG - 1.01)
        ci = np.clip((c * scale + IMG / 2 + dx), 0, IMG - 1.01)
        for t in range(n):  # 2x2 soft stamp ≈ stroke width
            i, j = int(ri[t]), int(ci[t])
            img[i:i + 2, j:j + 2] = 1.0
    return img


def add_noise(images: np.ndarray, kind: str, rng: np.random.Generator) -> np.ndarray:
    """The paper's three extension noises (Fig. 4)."""
    if kind == "gaussian":
        out = images + rng.normal(0.0, 0.25, images.shape).astype(np.float32)
    elif kind == "salt_pepper":
        out = images.copy()
        m = rng.random(images.shape)
        out[m < 0.05] = 0.0
        out[m > 0.95] = 1.0
    elif kind == "poisson":
        lam = np.clip(images, 0, 1) * 12.0 + 1e-3
        out = rng.poisson(lam).astype(np.float32) / 12.0
    else:
        raise ValueError(kind)
    return np.clip(out, 0.0, 1.0)


@dataclass
class SyntheticImageDataset:
    x: np.ndarray          # (N, 28, 28) float32 in [0,1]
    y: np.ndarray          # (N,) int32
    num_classes: int
    name: str

    def split(self, n_test: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        idx = rng.permutation(len(self.x))
        te, tr = idx[:n_test], idx[n_test:]
        return (SyntheticImageDataset(self.x[tr], self.y[tr], self.num_classes,
                                      self.name + ":train"),
                SyntheticImageDataset(self.x[te], self.y[te], self.num_classes,
                                      self.name + ":test"))


def _base_set(classes, n_per_class, rng, foolish_frac=0.0, single_caps=False):
    xs, ys = [], []
    for ci, g in enumerate(classes):
        for _ in range(n_per_class):
            xs.append(_render(g, rng))
            ys.append(ci)
    x = np.stack(xs)
    y = np.asarray(ys, np.int32)
    if foolish_frac > 0:
        n_fool = int(len(y) * foolish_frac)
        pick = rng.choice(len(y), n_fool, replace=False)
        # "foolish images": heavy distortion + sometimes wrong-looking glyph
        x[pick] = np.clip(x[pick] + rng.normal(0, 0.6, x[pick].shape), 0, 1)
    return x, y


def make_extended_mnist(n_per_class: int = 120, seed: int = 0) -> SyntheticImageDataset:
    """Base numeric set extended 3x with the paper's noises (IID by construction
    — every contiguous quarter of the shuffled set shares one distribution)."""
    rng = np.random.default_rng(seed)
    x0, y0 = _base_set(NUMERIC, n_per_class, rng)
    parts = [(x0, y0)]
    for kind in ("gaussian", "salt_pepper", "poisson"):
        parts.append((add_noise(x0, kind, rng), y0.copy()))
    x = np.concatenate([p[0] for p in parts])
    y = np.concatenate([p[1] for p in parts])
    idx = rng.permutation(len(x))
    return SyntheticImageDataset(x[idx].astype(np.float32), y[idx], 10, "ext-mnist")


def make_not_mnist(n_per_class: int = 120, seed: int = 1,
                   shuffled: bool = False) -> SyntheticImageDataset:
    """20-class numeric+alphabet set with look-alike pairs and foolish images.
    Left UNSHUFFLED (numeric block then alphabet block) unless ``shuffled`` —
    contiguous partitioning is then class-skewed, as in the paper's not-MNIST
    experiment where partitions saw different distributions."""
    rng = np.random.default_rng(seed)
    xn, yn = _base_set(NUMERIC, n_per_class, rng, foolish_frac=0.1)
    xa, ya = _base_set(ALPHA, n_per_class, rng, foolish_frac=0.15)
    x = np.concatenate([xn, xa]).astype(np.float32)
    y = np.concatenate([yn, ya + 10])
    if shuffled:
        idx = rng.permutation(len(x))
        x, y = x[idx], y[idx]
    return SyntheticImageDataset(x, y, 20, "not-mnist")


def one_hot(y: np.ndarray, num_classes: int) -> np.ndarray:
    out = np.zeros((len(y), num_classes), np.float32)
    out[np.arange(len(y)), y] = 1.0
    return out
