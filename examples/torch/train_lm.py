"""Train an LM end-to-end through the graph engine (deliverable b).

The PyTorch port's copy: ``repro_torch``'s train driver, on the card
unless ``--device cpu`` is given.  Default: the ~20M-param preset for a
few hundred steps; ``--preset lm100m`` selects the ~100M-class config.
The engine keeps every iteration's state (one Data Drop each), so the
default run holds 201 TrainStates of lm20m (~0.17 GB each).

Run:  PYTHONPATH=src python examples/torch/train_lm.py --steps 200
"""
import argparse
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

from repro_torch.launch.train import PRESETS, run_training  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=sorted(PRESETS), default="lm20m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_train_lm"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cuda raises if CUDA is "
                         "missing; pass cpu to run on the CPU)")
    args = ap.parse_args()
    cfg = PRESETS[args.preset]
    print(f"[example] training {cfg.name} "
          f"({cfg.param_count()/1e6:.1f}M params) for {args.steps} steps")
    res = run_training(cfg, steps=args.steps, shards=2, batch_per_shard=4,
                       seq=128, ckpt_dir=args.ckpt_dir, ckpt_every=50,
                       resume=args.resume, peak_lr=1e-3, device=args.device)
    assert res["last_loss"] < res["first_loss"], "loss must decrease"
    print("[example] OK — loss decreased "
          f"{res['first_loss']:.3f} -> {res['last_loss']:.3f}")


if __name__ == "__main__":
    main()
