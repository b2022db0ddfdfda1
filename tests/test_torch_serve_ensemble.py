"""``examples/serve_ensemble_torch.py`` — train, crash, serve, hot-swap —
on the CPU at its smoke size: the post-swap scores bitwise those of the
round-1 checkpoint, zero failed and zero dropped requests. It runs
threaded, under a wall-clock limit (``torch_bounded.bounded``)."""
import importlib
import os
import sys
from unittest import mock

import pytest
import torch

from torch_bounded import bounded

torch.set_num_threads(2)

EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def _example():
    sys.path.insert(0, EXAMPLES)
    try:
        return importlib.import_module("serve_ensemble_torch")
    finally:
        sys.path.remove(EXAMPLES)


@bounded(240)
def test_serve_ensemble_example_smoke_on_cpu():
    out = _example().main(["--smoke", "--device", "cpu"])
    assert out["bitwise"] and out["swaps"] == 1
    assert out["failed"] == 0 and out["dropped"] == 0
    assert out["completed"] > 0 and out["programs"] <= 4


def test_serve_ensemble_example_needs_a_card_by_default():
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _example().main(["--smoke"])
