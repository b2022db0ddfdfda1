"""Batched serving of the recurrent LMs on the PyTorch/CUDA port: RWKV6
decodes from its O(1)-in-sequence state, the Zamba2 hybrid from its Mamba2
states and the shared attention's per-invocation KV slots, both straight
from the prefill (no replay). The port's counterpart of
``examples/serve_batched.py``, at its reduced configs and sizes.

  PYTHONPATH=src python examples/serve_batched_torch.py --device cpu
  PYTHONPATH=src python examples/serve_batched_torch.py      # the card
"""
import argparse

from repro_torch.launch import serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, the plain PyTorch path")
    args = ap.parse_args(argv)
    print("== rwkv6 (SSM state decode, the long_500k path) ==")
    rwkv = serve.main(["--arch", "rwkv6_3b", "--reduced", "--batch", "4",
                       "--prompt-len", "64", "--gen", "24",
                       "--device", args.device])
    print("\n== zamba2 hybrid (SSM + shared-attention ring buffer) ==")
    zamba = serve.main(["--arch", "zamba2_1p2b", "--reduced", "--batch",
                        "2", "--prompt-len", "64", "--gen", "16",
                        "--device", args.device])
    return {"rwkv6": rwkv, "zamba2": zamba}


if __name__ == "__main__":
    main()
