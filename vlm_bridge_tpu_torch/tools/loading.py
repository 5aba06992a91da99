"""Shared CLI plumbing (port of vlm_bridge_tpu.tools.loading): model flags
and their resolution (preset -> seeded random init on the device -> HF
snapshots of the towers in its place -> a trained bridge from a
CheckpointStore slot -> int8 quantization -> tokenizer), and `--mesh` for the
data-parallel tools."""

from __future__ import annotations

from pathlib import Path

import torch

from vlm_bridge_tpu_torch.configs import TrainingConfig, VLMConfig

PRESETS = {"default": VLMConfig.default, "tiny": VLMConfig.tiny_test,
           "tiny_ref": VLMConfig.tiny_ref, "gemma2_9b": VLMConfig.gemma2_9b,
           "gemma2_27b": VLMConfig.gemma2_27b,
           # tiny widths with a sliding window that never binds at caption
           # lengths, so the fused int8 decode serves it (the JAX package's
           # TrainingConfig preset of the same purpose)
           "tiny_wide": lambda: TrainingConfig(model_preset="tiny_test_wide").model_config()}


def add_model_args(ap) -> None:
    """Attach the common model/weights/device argument set."""
    ap.add_argument("--checkpoint", default=None,
                    help="bridge checkpoint slot (e.g. checkpoints/exp/best)")
    ap.add_argument("--hf-vision-path", default=None,
                    help="local HF snapshot of facebook/dinov2-large (*.safetensors)")
    ap.add_argument("--hf-lm-path", default=None,
                    help="local HF snapshot of google/gemma-2-2b (*.safetensors)")
    ap.add_argument("--tokenizer-path", default=None)
    ap.add_argument("--preset", default="default", choices=sorted(PRESETS))
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "f32"],
                    help="frozen-weight dtype of the random init and of HF snapshot loads "
                         "(f32 for token-for-token parity checks; bf16 serves)")
    ap.add_argument("--quantize", default=None,
                    help="quantize weight groups: comma list of "
                         "embedding|embedding4,mlp,attn,bridge,vision (embedding4: "
                         "the table and its head at 4 bits; vision: the DINOv2 "
                         "layers' projections at int8)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device to build and run the model on (no fallback)")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random init")


def resolve_device(name) -> torch.device:
    """torch.device(name); a CUDA device without a card raises (no fallback)."""
    if torch.device(name).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda requested but torch.cuda.is_available() is False")
    return torch.device(name)


def load_from_args(args):
    """(cfg, params, tokenizer) resolved from the common argument set."""
    from vlm_bridge_tpu_torch.data.tokenizer import get_tokenizer
    from vlm_bridge_tpu_torch.models import bridge, dinov2, full_model, gemma2
    from vlm_bridge_tpu_torch.params.hf_loader import load_towers

    device = resolve_device(args.device)
    cfg = PRESETS[args.preset]()
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    dtype = torch.float32 if args.dtype == "f32" else torch.bfloat16
    params = full_model.init(cfg, generator=gen, frozen_dtype=dtype, device=device)
    params = load_towers(params, cfg, vision_path=getattr(args, "hf_vision_path", None),
                         lm_path=getattr(args, "hf_lm_path", None), dtype=dtype, device=device)
    if args.checkpoint:
        from vlm_bridge_tpu_torch.runtime.checkpoint import CheckpointStore

        p = Path(args.checkpoint)
        restored, meta = CheckpointStore(p.parent).load(
            p.name, template={"bridge_params": params["bridge"]})
        params["bridge"] = restored["bridge_params"]
        # what the trainer recorded (bridge_causal) for CLIs that match the
        # generation to how the bridge was trained
        args._ckpt_meta = meta
    if args.quantize:
        parts = args.quantize.split(",")
        lm_parts = tuple(p for p in parts if p not in ("bridge", "vision"))
        if lm_parts:
            params["lm"] = gemma2.quantize_params(params["lm"], parts=lm_parts)
        if "bridge" in parts:
            params["bridge"] = bridge.quantize_decode_params(params["bridge"])
        if "vision" in parts:
            params["vision"] = dinov2.quantize_vision_params(params["vision"])
    return cfg, params, get_tokenizer(args.tokenizer_path)


def mesh_from_args(args, params):
    """--mesh "D" or "D,M" -> (mesh, params broadcast from rank 0); (None,
    params) without it. D must be the process group's world size (1 without
    a group); M > 1, tensor parallelism of the frozen LM, raises
    NotImplementedError."""
    spec = getattr(args, "mesh", None)
    if not spec:
        return None, params
    parts = [int(x) for x in str(spec).split(",")]
    data = parts[0]
    model = parts[1] if len(parts) > 1 else 1

    from vlm_bridge_tpu_torch.parallel import auto_mesh, shard_params

    mesh = auto_mesh(data=data, model=model, device=resolve_device(args.device))
    return mesh, shard_params(mesh, params)


def prestack_decode_params(params, cfg, gen):
    """Stack the int8 decoder weights ONCE for serving (with gen.mlp_int4,
    the MLP weights at 4 bits) and drop the per-layer copies. No-op unless
    the fused stack decode serves this generation config: the per-layer path
    (no int8 KV cache, force_jnp or VLM_BRIDGE_DEBUG_FORCE_JNP, float layers,
    a window the cache outgrows) reads the per-layer dicts as they are and
    needs no second layout."""
    import os

    from vlm_bridge_tpu_torch.models import gemma2

    lm = params["lm"]
    if ("stacked_decode" in lm or "layers" not in lm or gen.exact or gen.force_jnp
            or os.environ.get("VLM_BRIDGE_DEBUG_FORCE_JNP") or not gen.kv_quant
            or not gemma2.supports_fused_decode(lm, cfg.lm, gen.max_length + 1)):
        return params
    lm = {k: v for k, v in lm.items() if k != "layers"}
    lm["stacked_decode"] = gemma2.stack_decode_params(
        params["lm"], cfg.lm, mlp_int4=gen.mlp_int4, mlp_int4_group=gen.mlp_int4_group)
    return {**params, "lm": lm}
