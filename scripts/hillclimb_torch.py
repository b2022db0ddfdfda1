"""The sharding hillclimb's variants on the PyTorch port — the port's
counterpart of ``scripts/hillclimb.py``: each variant (an arch, an input
shape, a rule override and a configuration override) traced as rank 0 of
the reference's 16 × 16 (data, model) ``pod`` mesh by the port's dry run
(``repro_torch.launch.dryrun.trace_mesh_combo``), which runs every layer
on meta tensors, so no probes are needed.

  PYTHONPATH=src python scripts/hillclimb_torch.py --list
  PYTHONPATH=src python scripts/hillclimb_torch.py --variant A1-fsdp-ff
  PYTHONPATH=src python scripts/hillclimb_torch.py --out DIR   # all 19

Per variant it prints the argument and peak bytes a card, the three
roofline terms and the leading one, and the collectives' calls and
multiplier-weighted bytes by mesh axis; ``--out DIR`` writes each
variant's dry-run report there as ``<variant>.json``. The figures are
build-host estimates priced at ``cost_analysis.CARD``'s data-sheet
rates, not card readings. Nothing here imports JAX.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.launch import dryrun                      # noqa: E402

# the reference's registry (scripts/hillclimb.py):
# name -> (arch, shape, rules_override, cfg_override, note)
VARIANTS = {
    # ---- pick B: rwkv6_3b x train_4k (worst roofline fraction) ----------
    "B0-paper-scan": ("rwkv6_3b", "train_4k", None, {"rwkv_mode": "scan"},
                      "paper-faithful exact recurrence (per-step scan)"),
    "B0-chunked": ("rwkv6_3b", "train_4k", None, None,
                   "baseline: chunked WKV, default sharding"),
    "B1-no-tp": ("rwkv6_3b", "train_4k", {"heads": ()}, None,
                 "tensor parallelism off on the time-mix D x D weights"),
    "B2-no-tp-fsdp": ("rwkv6_3b", "train_4k",
                      {"heads": (), "layers": ("data",)}, None,
                      "B1 + FSDP over the stacked-layer dim (32 % 16 == 0)"),
    "B3-head-pad48": ("rwkv6_3b", "train_4k", None, {"rwkv_head_pad_to": 16},
                      "heads padded 40 -> 48 so they divide model 16"),
    "B3-head-pad48-32k": ("rwkv6_3b", "prefill_32k", None,
                          {"rwkv_head_pad_to": 16},
                          "the head padding at the prefill shape"),
    "B4-pin-dataflow": ("rwkv6_3b", "train_4k", None,
                        {"rwkv_head_pad_to": 16},
                        "B3 with the time mix's dataflow pinned"),
    "B4-noheadpad": ("rwkv6_3b", "train_4k", None, None,
                     "the dataflow pins without the head padding"),
    # ---- pick C: olmoe_1b_7b x train_4k (most collective-bound) ---------
    "C0": ("olmoe_1b_7b", "train_4k", None, None, "baseline"),
    "C1-fsdp-ff": ("olmoe_1b_7b", "train_4k", {"ff": ("data",)}, None,
                   "FSDP: the expert ff dim over data, gathered at use"),
    "C2-combine-batch": ("olmoe_1b_7b", "train_4k", None,
                         {"moe_combine_sharding": "batch"},
                         "expert outputs gathered before the combine"),
    "C3-combine-none": ("olmoe_1b_7b", "train_4k", None,
                        {"moe_combine_sharding": "none"},
                        "no expert-dim constraint on the expert outputs"),
    # ---- bonus D: minicpm_2b x prefill_32k (worst memory-bound prefill) --
    "D0": ("minicpm_2b", "prefill_32k", None, None,
           "baseline: the vocab of 122,753 replicated over model"),
    "D1-vocab-pad": ("minicpm_2b", "prefill_32k", None, {"vocab_pad_to": 16},
                     "vocab padded to 122,768 so the logits shard"),
    "D2-vocab-pad-train": ("minicpm_2b", "train_4k", None,
                           {"vocab_pad_to": 16},
                           "the vocab padding in training"),
    "D2-base-train": ("minicpm_2b", "train_4k", None, None,
                      "train_4k baseline for D2"),
    # ---- pick A: qwen3_moe_235b x train_4k (paper-representative) -------
    "A0": ("qwen3_moe_235b_a22b", "train_4k", None, None,
           "baseline (does not fit a card)"),
    "A1-fsdp-ff": ("qwen3_moe_235b_a22b", "train_4k", {"ff": ("data",)},
                   None, "FSDP of the expert ff over data"),
    "A2-fsdp-combine": ("qwen3_moe_235b_a22b", "train_4k", {"ff": ("data",)},
                        {"moe_combine_sharding": "batch"},
                        "A1 + the combine's planned all-gather"),
}


def run_variant(name: str) -> dict:
    """The dry-run report of one variant on rank 0 of ``pod``."""
    arch, shape_name, rules, cfg_over, note = VARIANTS[name]
    shape = INPUT_SHAPES[shape_name]
    cfg = dryrun.shape_cfg(get_config(arch), shape)
    report = dryrun.trace_mesh_combo(cfg, shape, "pod",
                                     rules_override=rules,
                                     cfg_override=cfg_over)
    report.update(variant=name, note=note, cfg_override=cfg_over,
                  rules_override=rules and {k: list(v)
                                            for k, v in rules.items()})
    return report


def line(name: str, report: dict) -> str:
    """One printed line of a variant's report."""
    mem, roof, coll = (report["memory"], report["roofline"],
                       report["collectives"])
    by_axis = ", ".join(f"{axis}: {coll['count_by_axis'][axis]} calls "
                        f"{coll['per_card_bytes_by_axis'][axis] / 1e9:.3f} GB"
                        for axis in sorted(coll["count_by_axis"]))
    return (f"[{name}] args/card={mem['argument_bytes_per_card'] / 1e9:.3f}GB"
            f" peak/card={mem['peak_bytes_per_card'] / 1e9:.3f}GB "
            f"tc={roof['t_compute_s']:.4g}s tm={roof['t_memory_s']:.4g}s "
            f"tx={roof['t_collective_s']:.4g}s dom={roof['dominant']} "
            f"fits={mem['fits']} collectives by axis: {by_axis or 'none'} "
            f"trace={report['trace_s']:.1f}s")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    help="a variant's name (repeatable; default: all)")
    ap.add_argument("--list", action="store_true",
                    help="print the registry and exit")
    ap.add_argument("--out", help="write <variant>.json reports here")
    args = ap.parse_args(argv)
    if args.list:
        for name, (arch, shape, rules, cfg_over, note) in VARIANTS.items():
            print(f"{name:20s} {arch} x {shape} rules={rules} "
                  f"cfg={cfg_over} — {note}")
        return 0
    unknown = [n for n in args.variant if n not in VARIANTS]
    if unknown:
        ap.error(f"unknown variants {unknown}; --list names them")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    failed = 0
    t0 = time.perf_counter()
    for name in args.variant or list(VARIANTS):
        try:
            report = run_variant(name)
        except Exception as e:      # one variant's fault ends no sweep
            failed += 1
            print(f"[{name}] FAILED: {type(e).__name__}: {e}", flush=True)
            continue
        print(line(name, report), flush=True)
        if args.out:
            with open(os.path.join(args.out, f"{name}.json"), "w") as f:
                json.dump(report, f, indent=1)
    print(f"done: failed={failed} wall={time.perf_counter() - t0:.1f}s")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
