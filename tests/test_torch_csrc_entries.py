"""The C entry points of the port's kernel library against its sources.

``repro_torch.kernels`` loads one symbol a kernel (``kernels._ENTRIES``)
from the shared library that ``nvcc`` links out of ``csrc/*.cu``. Each must
be defined exactly once there as ``extern "C"`` (two definitions fail the
link on the card; none fails the load), and no other ``extern "C"``
function is defined: a kernel's calls reach its kernels from its one entry,
with no second hop through another C symbol.

CPU only: the sources are read as text; nothing is built.
"""
import re

import pytest

from repro_torch import kernels

# `extern "C" <return type> name(`: a declaration ends in `;` after its
# argument list, a definition opens a body `{`
_EXTERN_C = re.compile(r'extern\s+"C"\s+[\w\s\*]*?\b(\w+)\s*\(')


def _extern_c_definitions():
    """[(symbol, file)] of every extern "C" function defined under csrc/."""
    found = []
    for src in sorted(kernels.CSRC.glob("*.cu*")):
        text = src.read_text()
        for m in _EXTERN_C.finditer(text):
            depth, i = 1, m.end()
            while depth:
                depth += {"(": 1, ")": -1}.get(text[i], 0)
                i += 1
            if text[i:].lstrip().startswith("{"):
                found.append((m.group(1), src.name))
    return found


@pytest.mark.parametrize("name", sorted(kernels._ENTRIES))
def test_every_entry_is_defined_once_under_csrc(name):
    symbol = kernels._ENTRIES[name][0]
    where = [f for s, f in _extern_c_definitions() if s == symbol]
    assert len(where) == 1, (symbol, where)


def test_every_extern_c_definition_is_an_entry():
    entries = {fn for fn, _ in kernels._ENTRIES.values()}
    stray = [(s, f) for s, f in _extern_c_definitions() if s not in entries]
    assert not stray, stray


def test_the_attention_entries_live_beside_their_kernels():
    """The swa_attention forward's and backward's C entries are in the
    files of their kernels, swa_full_fwd.cu and swa_full_bwd.cu."""
    where = dict(_extern_c_definitions())
    assert where["swa_attention_fwd"] == "swa_full_fwd.cu"
    assert where["swa_attention_bwd"] == "swa_full_bwd.cu"
