"""`vlm-training-torch` CLI (port of vlm_bridge_tpu.training.cli; reference
training_strategy/cli.py:11-57).

  vlm-training-torch --config config/training-default.yaml [--resume [SLOT]] [--device cpu]

The run goes to the card unless --device cpu is given (no fallback). On a
first run with a missing config file, the defaults are written to that path
(reference cli.py:46-50).

Data-parallel over N cards of one host, one process each:

  torchrun --nproc-per-node N -m vlm_bridge_tpu_torch.training.cli --config C.yaml

The launcher's MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK / LOCAL_RANK
join the process group (NCCL; gloo with --device cpu) and the config's
mesh_shape sets the mesh: (-1,) every process on the data axis, (D, M) the
frozen LM cut over M processes of each data block; batch_size is the global
batch.
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
    from vlm_bridge_tpu_torch.parallel import init_multihost, process_info
    from vlm_bridge_tpu_torch.training.orchestrator import execute_full_training

    joined = init_multihost(device=args.device)
    if joined:
        print(f"[distributed] {process_info()}", flush=True)

    cfg_path = Path(args.config)
    tc = TrainingConfig.from_yaml(cfg_path)
    if not cfg_path.exists() and process_info()["process_index"] == 0:
        tc.to_yaml(cfg_path)
        print(f"wrote default config to {cfg_path}")
    if args.resume:
        tc.resume_from_checkpoint = args.resume

    try:
        result = execute_full_training(tc, device=args.device)
    finally:
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()
    print(f"training complete: best val loss {result['best_val_loss']:.4f} "
          f"over {result['epochs_run']} epochs")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
