"""`vlm-convert-torch` CLI: bridge checkpoint interop between the port's
CheckpointStore slots and the reference's .pth files (port of
vlm_bridge_tpu.tools.convert, whose Orbax slots become the port's slots).

  vlm-convert-torch pth-to-slot BRIDGE.pth STORE_DIR [--slot imported] [--preset tiny]
  vlm-convert-torch slot-to-pth STORE_DIR OUT.pth [--slot best_weights_only] [--preset tiny]
  vlm-convert-torch show BRIDGE.pth

pth-to-slot reads either of the reference's two layouts or a bare state dict
(params/torch_bridge.py) into a weights-only slot the port can train from or
serve (`--checkpoint STORE_DIR/SLOT`); slot-to-pth writes any slot back in
the reference's weights-only layout (FullModel.save_model). Conversion is
host-side file work: it runs on the CPU and touches no device.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from vlm_bridge_tpu_torch.tools.loading import PRESETS


def _bridge_cfg(preset: str):
    return PRESETS[preset]().bridge


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="vlm-convert-torch",
                                 description="bridge checkpoint conversion (PyTorch port)")
    sub = ap.add_subparsers(dest="command", required=True)

    p_i = sub.add_parser("pth-to-slot", help="reference .pth -> CheckpointStore slot")
    p_i.add_argument("pth", help="input .pth checkpoint")
    p_i.add_argument("out_dir", help="checkpoint store directory")
    p_i.add_argument("--slot", default="imported")
    p_i.add_argument("--preset", default="default", choices=sorted(PRESETS))

    p_e = sub.add_parser("slot-to-pth", help="CheckpointStore slot -> reference .pth")
    p_e.add_argument("store_dir", help="checkpoint store directory")
    p_e.add_argument("out_pth", help="output .pth path")
    p_e.add_argument("--slot", default="best_weights_only")
    p_e.add_argument("--preset", default="default", choices=sorted(PRESETS))

    p_s = sub.add_parser("show", help="print a .pth checkpoint's layout")
    p_s.add_argument("pth")

    args = ap.parse_args(argv)

    if args.command == "pth-to-slot":
        from vlm_bridge_tpu_torch.models.bridge import num_params
        from vlm_bridge_tpu_torch.params.torch_bridge import load_pth
        from vlm_bridge_tpu_torch.runtime.checkpoint import CheckpointStore

        params = load_pth(args.pth, _bridge_cfg(args.preset))
        CheckpointStore(args.out_dir).save(
            args.slot, bridge_params=params, meta={"source": str(Path(args.pth).resolve())})
        print(f"imported {num_params(params):,} params -> {args.out_dir}/{args.slot}")

    elif args.command == "slot-to-pth":
        import torch

        from vlm_bridge_tpu_torch.models import bridge as bridge_mod
        from vlm_bridge_tpu_torch.runtime.checkpoint import CheckpointStore

        cfg = _bridge_cfg(args.preset)
        template = bridge_mod.init(cfg, generator=torch.Generator().manual_seed(0))
        CheckpointStore(args.store_dir).export_pth(args.slot, cfg, args.out_pth,
                                                   template={"bridge_params": template})
        print(f"exported {args.store_dir}/{args.slot} -> {args.out_pth}")

    elif args.command == "show":
        import torch

        ckpt = torch.load(args.pth, map_location="cpu", weights_only=False)
        if "bridge_module_state_dict" in ckpt:
            layout, sd = "FullModel.save_model", ckpt["bridge_module_state_dict"]
        elif "model_state_dict" in ckpt:
            layout, sd = "trainer checkpoint", ckpt["model_state_dict"]
        else:
            layout, sd = "bare state dict", ckpt
        bridge_keys = [k for k in sd if "bridge_blocks" in k]
        n = sum(v.numel() for k, v in sd.items() if "bridge_blocks" in k)
        print(f"layout: {layout}; {len(bridge_keys)} bridge tensors, {n:,} params")
        for k in sorted(bridge_keys)[:8]:
            print(f"  {k}: {tuple(sd[k].shape)}")
        if len(bridge_keys) > 8:
            print(f"  ... {len(bridge_keys) - 8} more")
        if sd is not ckpt:  # wrapper layouts: list the non-weight sidecar keys
            extra = sorted(set(ckpt) - {"bridge_module_state_dict", "model_state_dict"})
            if extra:
                print(f"sidecar keys: {extra}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
