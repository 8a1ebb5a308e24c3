"""Serve a small model with batched requests through the graph engine.

The PyTorch port's copy: ``repro_torch``'s serve driver, on the card
unless ``--device cpu`` is given.

Run:  PYTHONPATH=src python examples/torch/serve_batch.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.launch.serve import run_serving  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="codeqwen15_7b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--decode", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda raises if CUDA is "
                         "missing; pass cpu to run on the CPU)")
    args = ap.parse_args()
    cfg = get_smoke_config(args.arch)
    res = run_serving(cfg, num_requests=args.requests,
                      decode_steps=args.decode, device=args.device)
    assert res["responses_shape"] == (args.requests, args.decode)
    print("[example] OK —", res["responses_shape"], "tokens generated")


if __name__ == "__main__":
    main()
