"""`vlm-training-torch` CLI (port of vlm_bridge_tpu.training.cli; reference
training_strategy/cli.py:11-57).

  vlm-training-torch --config config/training-default.yaml [--resume [SLOT]] [--device cpu]

The run goes to the card unless --device cpu is given (no fallback). On a
first run with a missing config file, the defaults are written to that path
(reference cli.py:46-50).
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="vlm-training-torch",
        description="Bridge-only training of the captioning stack (PyTorch port)")
    parser.add_argument("--config", default="config/training-default.yaml")
    parser.add_argument("--resume", nargs="?", const="latest", default=None,
                        help="resume from a checkpoint slot (default: latest)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="device to train on (no fallback)")
    args = parser.parse_args(argv)

    from vlm_bridge_tpu_torch.configs import TrainingConfig
    from vlm_bridge_tpu_torch.training.orchestrator import execute_full_training

    cfg_path = Path(args.config)
    tc = TrainingConfig.from_yaml(cfg_path)
    if not cfg_path.exists():
        tc.to_yaml(cfg_path)
        print(f"wrote default config to {cfg_path}")
    if args.resume:
        tc.resume_from_checkpoint = args.resume

    result = execute_full_training(tc, device=args.device)
    print(f"training complete: best val loss {result['best_val_loss']:.4f} "
          f"over {result['epochs_run']} epochs")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
