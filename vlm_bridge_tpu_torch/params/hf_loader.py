"""HuggingFace checkpoint -> the port's parameter trees (port of
vlm_bridge_tpu.params.hf_loader).

Maps the on-disk naming of `google/gemma-2-2b` (Gemma2ForCausalLM) and
`facebook/dinov2-large` (Dinov2Model) onto the trees that
`gemma2.init` / `dinov2.init` make. Works from an in-memory state dict
(tests use tiny random HF models) or a local snapshot directory of
`*.safetensors` files, read by `load_safetensors_dir`, a reader of the format
itself: an 8-byte little-endian header length, a JSON header of dtype, shape
and byte offsets, then the raw bytes. Neither `safetensors` nor
`transformers` is needed.

torch's nn.Linear stores weights [out, in]; the port stores [in, out], so
every dense weight is transposed once here. Each tensor is cast to the target
dtype on the host, one at a time, then placed on the device, where the
transposes and the q | k | v concatenation run: a snapshot in f32 is never
held a second time in f32.
"""

from __future__ import annotations

import json
import mmap
import struct
import sys
from pathlib import Path
from typing import Dict, Mapping

import torch

from vlm_bridge_tpu_torch.configs import DinoV2Config, Gemma2Config

# safetensors dtype names -> torch dtypes (the format is little-endian)
_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
           "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
           "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
           "U16": torch.uint16, "U32": torch.uint32, "U64": torch.uint64,
           "F8_E4M3": torch.float8_e4m3fn, "F8_E5M2": torch.float8_e5m2}


# ---------------------------------------------------------------------------
# Safetensors directory reading
# ---------------------------------------------------------------------------


def read_safetensors(path: str | Path) -> Dict[str, torch.Tensor]:
    """One `.safetensors` file -> {name: CPU tensor in its stored dtype}.

    The file is mapped copy-on-write and each tensor views the mapped bytes
    (the map lives as long as a tensor does); a tensor whose byte offset is
    not a multiple of its element size is copied out first, so no bytes are
    reinterpreted at a misaligned address."""
    if sys.byteorder != "little":
        raise RuntimeError("safetensors data is little-endian; this host is not")
    path = Path(path)
    with path.open("rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: shorter than a safetensors header")
        (n,) = struct.unpack("<Q", head)
        header = json.loads(f.read(n))
        size = path.stat().st_size
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size > 8 + n else None
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, which is not read")
        shape = [int(d) for d in info["shape"]]
        begin, end = (int(x) for x in info["data_offsets"])
        numel = 1
        for d in shape:
            numel *= d
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - begin != numel * itemsize or base + end > size:
            raise ValueError(f"{path}: {name} spans bytes [{begin}, {end}) for shape {shape} "
                             f"of {info['dtype']}")
        if numel == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        raw = torch.frombuffer(mm, dtype=torch.uint8, count=end - begin, offset=base + begin)
        if (base + begin) % itemsize:
            raw = raw.clone()   # a fresh, aligned buffer
        out[name] = raw.view(dtype).reshape(shape)
    return out


def load_safetensors_dir(path: str | Path) -> Dict[str, torch.Tensor]:
    """Every `*.safetensors` of a local HF snapshot directory in one dict of
    CPU tensors in their stored dtype (the index JSON is not needed: the
    shards are globbed)."""
    path = Path(path)
    files = sorted(path.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    sd: Dict[str, torch.Tensor] = {}
    for f in files:
        sd.update(read_safetensors(f))
    return sd


# ---------------------------------------------------------------------------
# Conversion helpers
# ---------------------------------------------------------------------------


def _as(x: torch.Tensor, dtype, device) -> torch.Tensor:
    """Cast on the host, then place on the device."""
    return x.detach().to("cpu").to(dtype).contiguous().to(device)


def _dense(w: torch.Tensor, dtype, device) -> torch.Tensor:
    """[out, in] -> [in, out]: cast, placed, then transposed on the device."""
    return _as(w, dtype, device).t().contiguous()


# ---------------------------------------------------------------------------
# Gemma-2
# ---------------------------------------------------------------------------


def gemma2_from_state_dict(sd: Mapping[str, torch.Tensor], cfg: Gemma2Config,
                           dtype=torch.bfloat16, device=None) -> dict:
    """Convert a Gemma2ForCausalLM (or Gemma2Model) state dict."""
    p = "model." if any(k.startswith("model.") for k in sd) else ""

    def g(name):
        return sd[p + name]

    layers = {}
    for i in range(cfg.num_layers):
        lp = f"layers.{i}."
        layers[str(i)] = {
            "input_norm": _as(g(lp + "input_layernorm.weight"), dtype, device),
            "post_attn_norm": _as(g(lp + "post_attention_layernorm.weight"), dtype, device),
            "pre_ffn_norm": _as(g(lp + "pre_feedforward_layernorm.weight"), dtype, device),
            "post_ffn_norm": _as(g(lp + "post_feedforward_layernorm.weight"), dtype, device),
            "attn": {k: _dense(g(lp + f"self_attn.{k}_proj.weight"), dtype, device)
                     for k in ("q", "k", "v", "o")},
            "mlp": {k: _dense(g(lp + f"mlp.{k}_proj.weight"), dtype, device)
                    for k in ("gate", "up", "down")},
        }
    return {"embedding": _as(g("embed_tokens.weight"), dtype, device),
            "final_norm": _as(g("norm.weight"), dtype, device),
            "layers": layers}


# ---------------------------------------------------------------------------
# DINOv2
# ---------------------------------------------------------------------------


def dinov2_from_state_dict(sd: Mapping[str, torch.Tensor], cfg: DinoV2Config,
                           dtype=torch.bfloat16, *, target_grids: tuple = (16,),
                           device=None) -> dict:
    """Convert a Dinov2Model state dict.

    target_grids: patch grids (16 for 224 px) whose position tables are
    precomputed as `pos_embed_interp_{grid}` with torch's bicubic (A = -0.75,
    as HF's interpolate_pos_encoding), in f32 on the host; dinov2.forward
    reads such a table in place of its own A = -0.5 resize."""
    def ln(name):
        return {"scale": _as(sd[name + ".weight"], dtype, device),
                "bias": _as(sd[name + ".bias"], dtype, device)}

    layers = {}
    for i in range(cfg.num_layers):
        lp = f"encoder.layer.{i}."
        if cfg.use_swiglu_ffn:  # dinov2-giant (HF Dinov2SwiGLUFFN keys)
            mlp = {"win": _dense(sd[lp + "mlp.weights_in.weight"], dtype, device),
                   "win_bias": _as(sd[lp + "mlp.weights_in.bias"], dtype, device),
                   "wout": _dense(sd[lp + "mlp.weights_out.weight"], dtype, device),
                   "wout_bias": _as(sd[lp + "mlp.weights_out.bias"], dtype, device)}
        else:
            mlp = {"fc1": _dense(sd[lp + "mlp.fc1.weight"], dtype, device),
                   "fc1_bias": _as(sd[lp + "mlp.fc1.bias"], dtype, device),
                   "fc2": _dense(sd[lp + "mlp.fc2.weight"], dtype, device),
                   "fc2_bias": _as(sd[lp + "mlp.fc2.bias"], dtype, device)}
        a = lp + "attention.attention."
        layers[str(i)] = {
            "norm1": ln(lp + "norm1"),
            "norm2": ln(lp + "norm2"),
            "attn": {
                # q | k | v fused along the output dim (see dinov2.init)
                "qkv": torch.cat([_as(sd[a + f"{k}.weight"], dtype, device).t()
                                  for k in ("query", "key", "value")], dim=1),
                "qkv_bias": torch.cat([_as(sd[a + f"{k}.bias"], dtype, device)
                                       for k in ("query", "key", "value")]),
                "o": _dense(sd[lp + "attention.output.dense.weight"], dtype, device),
                "o_bias": _as(sd[lp + "attention.output.dense.bias"], dtype, device),
            },
            "mlp": mlp,
            "layerscale1": _as(sd[lp + "layer_scale1.lambda1"], dtype, device),
            "layerscale2": _as(sd[lp + "layer_scale2.lambda1"], dtype, device),
        }

    pos_embed = sd["embeddings.position_embeddings"]
    kernel = _as(sd["embeddings.patch_embeddings.projection.weight"], dtype, device)
    params = {
        # torch conv OIHW [h, C, ph, pw] -> HWIO [ph, pw, C, h]
        "patch_embed": {"kernel": kernel.permute(2, 3, 1, 0).contiguous(),
                        "bias": _as(sd["embeddings.patch_embeddings.projection.bias"], dtype,
                                    device)},
        "cls_token": _as(sd["embeddings.cls_token"], dtype, device),
        "pos_embed": _as(pos_embed, dtype, device),
        "final_norm": ln("layernorm"),
        "layers": layers,
    }
    for grid in target_grids:
        if grid == cfg.native_grid:
            continue
        params[f"pos_embed_interp_{grid}"] = _as(_torch_bicubic_pos_interp(pos_embed, grid),
                                                 dtype, device)
    return params


def _torch_bicubic_pos_interp(pos_embed: torch.Tensor, grid: int) -> torch.Tensor:
    """[1, 1 + N, h] position embeddings resized to a grid x grid patch grid
    as HF Dinov2Embeddings.interpolate_pos_encoding does (f32 bicubic,
    align_corners=False), on the host's CPU whatever device follows."""
    pos = pos_embed.detach().to("cpu", torch.float32)
    native = int(round((pos.shape[1] - 1) ** 0.5))
    h = pos.shape[-1]
    patch = pos[:, 1:].reshape(1, native, native, h).permute(0, 3, 1, 2)
    patch = torch.nn.functional.interpolate(patch, size=(grid, grid), mode="bicubic",
                                            align_corners=False)
    patch = patch.permute(0, 2, 3, 1).reshape(1, grid * grid, h)
    return torch.cat([pos[:, :1], patch], dim=1)


def load_gemma2(path: str | Path, cfg: Gemma2Config, dtype=torch.bfloat16,
                device=None) -> dict:
    return gemma2_from_state_dict(load_safetensors_dir(path), cfg, dtype, device)


def load_dinov2(path: str | Path, cfg: DinoV2Config, dtype=torch.bfloat16,
                target_grids: tuple = (16,), device=None) -> dict:
    return dinov2_from_state_dict(load_safetensors_dir(path), cfg, dtype,
                                  target_grids=target_grids, device=device)


def load_towers(params: dict, cfg, *, vision_path=None, lm_path=None, dtype=torch.bfloat16,
                device=None) -> dict:
    """A full tree (a VLMConfig's `init`) with the HF snapshots in place of
    its vision / lm subtrees where a path is given; the vision tower gets the
    position table of cfg.image_size's grid."""
    if vision_path:
        params["vision"] = load_dinov2(vision_path, cfg.vision, dtype,
                                       target_grids=(cfg.image_size // cfg.vision.patch_size,),
                                       device=device)
    if lm_path:
        params["lm"] = load_gemma2(lm_path, cfg.lm, dtype, device)
    return params
