"""End-to-end driver on the PyTorch/CUDA port — distributed-averaging
training of a transformer LM.

The paper's technique at LM scale: k members train a dense GQA decoder on
disjoint synthetic token streams with no communication, the weights are
averaged every tau steps (tau = 0: the paper's single final average), and
the averaged model is evaluated against every member. On the card every
rms_norm and attention, forward and backward, runs through the port's
hand-written CUDA kernels; on the CPU through their plain PyTorch versions.

  PYTHONPATH=src python examples/distributed_averaging_lm_torch.py \\
      --device cpu                                  # reduced, ~20 s
  PYTHONPATH=src python examples/distributed_averaging_lm_torch.py --full
                                                    # ~100M params, the card
"""
import argparse

from repro_torch.launch import train as train_launcher


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="~100M params, 200 steps (sized for the card)")
    ap.add_argument("--non-iid", action="store_true",
                    help="disjoint data domains per member — the paper's "
                         "not-MNIST degradation at LM scale")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    # the rounds contract: 4 averaging events spread over the run
    if args.full:
        argv = ["--preset", "lm100m", "--steps", "200", "--members", "2",
                "--batch", "8", "--seq", "512", "--rounds", "4",
                "--log-every", "10"]
    else:
        argv = ["--arch", "qwen3_8b", "--reduced", "--steps", "40",
                "--members", "2", "--batch", "4", "--seq", "128",
                "--rounds", "4", "--log-every", "5"]
    if args.non_iid:
        argv.append("--non-iid")
    argv += ["--device", args.device]

    result = train_launcher.main(argv)
    avg, members = result["eval_averaged"], result["eval_members"]
    print("\n=== distributed averaging result ===")
    print(f"averaged model loss: {avg:.4f}")
    print(f"member losses:       {['%.4f' % m for m in members]}")
    if avg <= min(members) + 0.05:
        print("-> averaging preserved (or improved) member quality, "
              "with zero inter-member traffic during training")
    else:
        print("-> averaging degraded quality — expected under --non-iid "
              "(the paper's Table 2/3 failure mode)")


if __name__ == "__main__":
    main()
