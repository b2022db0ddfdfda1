"""Build, load and count the port's hand-written CUDA kernels.

Every kernel lives in ``repro_torch/csrc/*.cu`` behind a plain C interface.
``library()`` compiles them with ``nvcc`` for ``sm_90a`` at first use — one
``nvcc -c`` per source, all started together, then one link into a single
shared library — and loads it with ``ctypes``. The build lands in the
repository's ``build/`` directory under a name that hashes the sources, so
an edited kernel is rebuilt and a finished build is reused.

Each kernel's ``ops.py`` routes by device: a CPU tensor goes to the plain
PyTorch version in ``ref.py``, any other tensor to the kernel's operator
in the ``torch.ops.repro_torch`` namespace (``register``). On a CUDA
tensor the operator launches the kernel; on a meta tensor it gives its
outputs' shapes and dtypes and computes nothing, so a whole step can be
traced without a card (``launch/dryrun.py``), and ``FlopCounterMode``
counts each launch by the operator's FLOP formula. Nothing falls back
from one route to another: a failed build or launch raises. Importing
this package registers the operators; it neither builds nor loads the
CUDA library.

``LAUNCHES`` counts kernel launches per kernel name; each wrapper adds one
where it launches, and nowhere else, so a run can show that its main path
went through the kernels (``reset_launches`` before, read after). A
kernel's backward has a name of its own (``rmsnorm_bwd``,
``swa_attention_bwd``), counted in its ``torch.autograd.Function``'s
``backward``, which runs on autograd's engine thread.

A captured CUDA graph runs its kernels without a Python call, so the count
follows the graph: launches made while a thread captures
(``capture_launches``) run nothing and go into the graph's record instead
of ``LAUNCHES``, and every replay adds that record back (``count_replay``).
A kernel launched into a capture that keeps no record raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from contextlib import contextmanager
from pathlib import Path
from typing import Callable, Dict, Iterator

import torch
from torch.utils.flop_counter import register_flop_formula

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# kernel name -> (C entry point, its argument types); every entry point
# returns cudaGetLastError() as an int
_ENTRIES = {
    # x, w, y, k, B, H, W, Cin, kh, kw, Cout, stream
    "conv2d": ("conv2d_valid_f32",
               (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P)),
    # x, dy, partial sums, dw, k, B, H, W, Cin, kh, kw, Cout, images a
    # chunk, stream
    "conv2d_wgrad": ("conv2d_wgrad_f32",
                     (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                      _P)),
    # dy, w, dx, k, B, H, W, Cin, kh, kw, Cout (H, W, Cin: dx's), stream
    "conv2d_dgrad": ("conv2d_dgrad_f32",
                     (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P)),
    # h, t, mask (NULL = unmasked), out, k, n, L, C, stream
    "elm_stats": ("elm_stats_f32", (_P, _P, _P, _P, _I, _I, _I, _I, _P)),
    # x, scale, out, n, D, eps, x is bf16, scale is bf16, stream
    "rmsnorm": ("rmsnorm_fwd", (_P, _P, _P, _I, _I, _F, _I, _I, _P)),
    # x, scale, dy, dx, partial sums, dscale, n, D, rows a chunk, eps, x is
    # bf16, scale is bf16, stream
    "rmsnorm_bwd": ("rmsnorm_bwd",
                    (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _P)),
    # q, k, v, out, lse (NULL = none), B, S, H, KV, hd, window, causal,
    # scale, bf16, stream
    "swa_attention": ("swa_attention_fwd",
                      (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                       _I, _P)),
    # q, k, v, out, dout, lse, delta, dq, dk, dv, B, S, H, KV, hd, window,
    # causal, scale, bf16, stream
    "swa_attention_bwd": ("swa_attention_bwd",
                          (_P,) * 10 + (_I,) * 7 + (_F, _I, _P)),
}

LAUNCHES = {name: 0 for name in _ENTRIES}

NAMESPACE = "repro_torch"
LIB = torch.library.Library(NAMESPACE, "DEF")
OPS: Dict[str, "torch._ops.OpOverload"] = {}    # kernel name -> operator

_lock = threading.Lock()
_count_lock = threading.Lock()      # a serving worker and a trainer count
_capturing = threading.local()      # .record: the capture's launches
_lib = None
build_log = ""


def reset_launches():
    with _count_lock:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


@contextmanager
def capture_launches() -> Iterator[Dict[str, int]]:
    """While this thread captures a CUDA graph: yield the record of the
    launches the capture makes, which are kept out of ``LAUNCHES`` (a
    capture runs no kernel); ``count_replay(record)`` adds them per
    replay."""
    record = {name: 0 for name in _ENTRIES}
    _capturing.record = record
    try:
        yield record
    finally:
        _capturing.record = None


def count_replay(record: Dict[str, int]):
    """Count one replay of a graph whose capture made ``record``."""
    with _count_lock:
        for name, n in record.items():
            LAUNCHES[name] += n


def needs_grad(tensors) -> bool:
    """Whether a call on ``tensors`` is recorded by autograd."""
    return torch.is_grad_enabled() and any(a.requires_grad for a in tensors)


def refuse_grad(name: str, tensors):
    """Raise for an operand that requires grad while grad mode is on: the
    kernel ``name`` has no backward (elm_stats), and its output, a buffer
    the kernel fills, would silently cut the graph."""
    if needs_grad(tensors):
        raise RuntimeError(
            f"the {name} kernel has no backward yet: call it under "
            f"torch.no_grad() or on operands that do not require grad "
            f"(the CPU route is differentiable)")


def register(name: str, schema: str, cuda_impl: Callable,
             fake_impl: Callable, flops: Callable):
    """Define the operator ``repro_torch::<name>(<schema>)`` of kernel
    ``name`` and return it: ``cuda_impl`` is its CUDA implementation (it
    launches the kernel through ``launch``), ``fake_impl`` returns empty
    outputs of the right shapes and dtypes (the meta device and fake
    tensors), and ``flops(*shapes, out_shape=...)`` is the work one call
    does, counted by ``torch.utils.flop_counter.FlopCounterMode``. The
    operator is functional: every buffer the kernel writes, a workspace
    included, is one of its outputs."""
    if name not in _ENTRIES:
        raise KeyError(f"no kernel entry point named {name!r}")
    LIB.define(name + schema)
    LIB.impl(name, cuda_impl, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake_impl, lib=LIB)
    packet = getattr(getattr(torch.ops, NAMESPACE), name)
    register_flop_formula(packet)(flops)
    OPS[name] = packet.default
    return packet.default


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "repro_torch/csrc at first use and need the CUDA "
                       "toolkit")


def _build(target: Path) -> str:
    sources = sorted(CSRC.glob("*.cu"))
    nvcc = _nvcc()
    target.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        objs, procs = [], []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate()[0] for p in procs]
        for src, p, log in zip(sources, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        so = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(so, target)      # atomic: concurrent builds agree
    return "".join(logs)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib, build_log
    with _lock:
        if _lib is None:
            digest = hashlib.sha256()
            for src in sorted(CSRC.glob("*.cu*")):     # .cu and .cuh
                digest.update(src.name.encode() + src.read_bytes())
            digest.update(" ".join(NVCC_FLAGS).encode())
            target = BUILD_DIR / f"libkernels-{digest.hexdigest()[:16]}.so"
            if not target.exists():
                build_log = _build(target)
            lib = ctypes.CDLL(str(target))
            for fn_name, argtypes in _ENTRIES.values():
                fn = getattr(lib, fn_name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def launch(name: str, *args, passes: int = 1):
    """Launch kernel ``name`` on the current stream with ``args`` and count
    its launches: ``passes`` for an entry point that launches its kernel in
    that many passes, else one; raise if CUDA reports an error."""
    fn_name = _ENTRIES[name][0]
    record = getattr(_capturing, "record", None)
    if record is None and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"{name} launched into a CUDA graph capture that keeps no launch "
            f"record: capture under kernels.capture_launches()")
    err = getattr(library(), fn_name)(
        *args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed: CUDA error {err}")
    if record is not None:
        record[name] += passes
        return
    with _count_lock:
        LAUNCHES[name] += passes


# the operators: each kernel's ops.py registers its own (``register``)
from repro_torch.kernels.conv2d import ops as _conv  # noqa: E402,F401
from repro_torch.kernels.elm_stats import ops as _elm  # noqa: E402,F401
from repro_torch.kernels.rmsnorm import ops as _rms  # noqa: E402,F401
from repro_torch.kernels.swa_attention import ops as _swa  # noqa: E402,F401
