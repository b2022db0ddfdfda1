"""Tree checkpointing to .npz with structure and dtype metadata — the port's
counterpart of ``repro.checkpoint.ckpt``, in the reference's file format,
so that a file either package writes, the other restores.

The format: one ``<name>-<step:08d>.npz`` per save; the nested dict path of
each leaf joined by ``/``, tuple and list items as ``#<i>``; a ``__meta__``
entry holding the JSON of ``step``, ``metadata`` and ``dtypes``. numpy has
no bfloat16, so a bf16 leaf is stored as its ``uint16`` bits and
``dtypes`` records it as ``"bfloat16"`` (the name the reference's numpy
extension gives it); it comes back as ``torch.bfloat16``, bit for bit.
Saves are atomic by a tmp file and ``os.replace``.
"""
from __future__ import annotations

import json
import os
import re
import tempfile

import numpy as np
import torch

from repro_torch import resolve_device

BF16 = "bfloat16"


def _leaf(a, key: str, dtypes: dict) -> np.ndarray:
    if not isinstance(a, torch.Tensor):
        return np.asarray(a)
    a = a.detach().cpu()
    if a.dtype == torch.bfloat16:
        dtypes[key] = BF16
        return a.view(torch.int16).numpy().view(np.uint16)
    return a.numpy()


def _flatten(tree, dtypes: dict, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, dtypes, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, dtypes, f"{prefix}#{i}/"))
    else:
        out[prefix[:-1]] = _leaf(tree, prefix[:-1], dtypes)
    return out


def _unflatten(flat):
    root = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(re.fullmatch(r"#\d+", k) for k in node):
            return tuple(fix(node[f"#{i}"]) for i in range(len(node)))
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def checkpoint_path(ckpt_dir: str, name: str, step: int) -> str:
    """Where checkpoint ``name`` number ``step`` lands in ``ckpt_dir``."""
    return os.path.join(ckpt_dir, f"{name}-{step:08d}.npz")


def save_checkpoint(ckpt_dir: str, name: str, step: int, tree, metadata=None):
    """Atomic save of a tree of tensors (or numpy arrays): the whole .npz is
    written to a tmp file first, and the final ``os.replace`` is the only
    point where the file appears — a crash mid-save leaves the previous
    checkpoint (if any) untouched and never a partial file at its path. A
    failed write removes its tmp file."""
    os.makedirs(ckpt_dir, exist_ok=True)
    dtypes: dict = {}
    flat = _flatten(tree, dtypes)
    flat["__meta__"] = np.frombuffer(
        json.dumps({"step": step, "metadata": metadata or {},
                    "dtypes": dtypes}).encode(), np.uint8)
    path = checkpoint_path(ckpt_dir, name, step)
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def _tensor(val: np.ndarray, dtype, key: str, dev) -> torch.Tensor:
    if dtype is None:
        return torch.from_numpy(val).to(dev)
    if dtype == BF16:
        return torch.from_numpy(val.view(np.int16)).view(torch.bfloat16).to(
            dev)
    raise ValueError(f"checkpoint leaf {key!r} is stored as {dtype!r}, "
                     f"which has no torch dtype here")


def restore_checkpoint(ckpt_dir: str, name: str, step: int | None = None,
                       device="cuda"):
    """(the tree of tensors on ``device``, the metadata) of step ``step`` of
    ``name`` (the newest without one); the tensors go to the card unless
    ``device="cpu"``."""
    dev = resolve_device(device)
    if step is None:
        step = latest_step(ckpt_dir, name)
        if step is None:
            raise FileNotFoundError(f"no checkpoint '{name}' in {ckpt_dir}")
    with np.load(checkpoint_path(ckpt_dir, name, step)) as z:
        flat = {k: z[k] for k in z.files}
    meta = json.loads(bytes(flat.pop("__meta__")).decode())
    dtypes = meta.pop("dtypes", {})
    return _unflatten({k: _tensor(v, dtypes.get(k), k, dev)
                       for k, v in flat.items()}), meta


def list_steps(ckpt_dir: str, name: str):
    """All saved steps of ``name`` in ascending order (empty when none)."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for f in os.listdir(ckpt_dir)
                  if (m := re.fullmatch(rf"{re.escape(name)}-(\d+)\.npz", f)))


def latest_step(ckpt_dir: str, name: str):
    steps = list_steps(ckpt_dir, name)
    return steps[-1] if steps else None


def peek_step(ckpt_dir: str, name: str, step: int):
    """The metadata dict of a checkpoint if it is fully readable, else None.
    Reading ``__meta__`` walks the zip's central directory, stored at the
    end of the file, so a torn or truncated write fails here."""
    try:
        with np.load(checkpoint_path(ckpt_dir, name, step)) as z:
            return json.loads(bytes(z["__meta__"]).decode())
    except Exception:       # any unreadable file is "not ready yet"
        return None


def latest_valid_step(ckpt_dir: str, name: str):
    """Newest step of ``name`` whose file is fully readable, for a reader
    polling a directory a writer still appends to: in-flight ``*.tmp`` files
    never match the step pattern, and a torn ``<name>-<step>.npz`` fails
    ``peek_step`` and is skipped in favour of the newest older valid step
    (the next poll tries it again). None when no valid step exists yet."""
    for step in reversed(list_steps(ckpt_dir, name)):
        if peek_step(ckpt_dir, name, step) is not None:
            return step
    return None
