"""``repro_torch.analysis`` — the port's contract-enforcement layer, the
counterpart of ``repro.analysis``.

* **The static lint** (``repro_torch.analysis.lint`` +
  ``repro_torch.analysis.rules``): AST rules over the port's sources — the
  reference's rules in torch form (numpy, host syncs, clocks and host RNG
  under CUDA-graph capture; sub-f32 accumulation; literal member seeds;
  graphs outside the scorer; unregistered Reduce strategies) and the
  port's ground rules (no TF32, no kernel wrapper that cuts autograd,
  every collective through ``distributed/collectives.py``, no entry point
  that defaults to the CPU), with inline
  ``# repro_torch: allow(<rule>)  <reason>`` suppressions, a checked-in
  (empty) baseline and a fail-on-new CI mode.
  ``python -m repro_torch.analysis`` is the CLI.
* **The runtime contract audit** (``repro_torch.analysis.audit``): where
  the reference reads compiled HLO, the port runs each program once and
  records what it did — every aten op with its output dtypes and the
  storages it wrote, the hand kernels' launches, the collectives per
  span — then holds that record to the same contracts (f32 accumulation,
  one live copy of a carry, the collective counts, the compile budget,
  and on the card the hand-kernel route).
"""
from repro_torch.analysis.lint import (DEFAULT_ROOTS, Finding,  # noqa: F401
                                       LintReport, default_paths, lint_file,
                                       lint_paths, load_baseline,
                                       write_baseline)
from repro_torch.analysis.rules import RULES, Rule, get_rules  # noqa: F401

# NOTE: repro_torch.analysis.audit is not imported here — it pulls in the
# executor stack, which the pure-AST CLI never needs. ``from
# repro_torch.analysis import audit`` explicitly when auditing programs.
