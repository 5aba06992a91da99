"""A tiny configuration and cells of each entry, for the CPU tests: the
port's plain versions run where the card's kernels would."""

from __future__ import annotations

import copy

TINY_PORT = {
    "image_size": 70,
    "vision": {"hidden_size": 32, "num_layers": 2, "num_heads": 4, "mlp_ratio": 2,
               "patch_size": 14, "image_size": 70, "num_channels": 3, "layer_norm_eps": 1e-06,
               "layerscale_value": 1.0, "qkv_bias": True, "use_swiglu_ffn": False},
    # a window past the caption's cache rows, so the fused stack decode serves it
    "lm": {"vocab_size": 512, "hidden_size": 64, "intermediate_size": 128, "num_layers": 4,
           "num_heads": 4, "num_kv_heads": 2, "head_dim": 16, "max_position_embeddings": 128,
           "rms_norm_eps": 1e-06, "rope_theta": 10000.0, "query_pre_attn_scalar": 16.0,
           "sliding_window": 128, "attn_logit_softcap": 50.0, "final_logit_softcap": 30.0,
           "pad_token_id": 0, "eos_token_id": 1, "bos_token_id": 2},
    "bridge": {"vision_dim": 32, "language_dim": 64, "num_blocks": 2, "num_heads_cross": 2,
               "num_heads_self": 4, "ffn_mult": 2, "dropout": 0.1, "layer_norm_eps": 1e-05},
}
CFG_FILE = {"name": "tiny", "port": TINY_PORT}

CAPTION = {
    "config": "tiny", "entry": "caption",
    "traffic": {"bridge_gain": 0.1, "batch": 4, "new_tokens": 6, "pool": 3, "kv_int8": True,
                "mlp_int4": False,
                "mlp_int4_group": 128, "quantize": ["embedding", "mlp", "attn", "bridge"],
                "sampling": None, "greedy_every": None, "trace_batches": 2,
                "check_batches": 2},
    # limits between the tiny cells' sound readings (<= 0.006) and what the
    # control and the planted faults read (>= 0.06)
    "checks": {"greedy_gap": {"limit": 0.02}},
    "control": {"forms": {"attn": "int4", "mlp": "int4", "table": "int4_rows",
                          "bridge": "int4"}},
}
SAMPLED = copy.deepcopy(CAPTION)
SAMPLED["traffic"].update(sampling={"temperature": 0.7, "top_p": 0.9, "topk_window": 16},
                          greedy_every=2, trace_batches=4)
SAMPLED["checks"] = {"greedy_gap": {"limit": 0.02}, "window_gap": {"limit": 0.03}}

TRAIN = {
    "config": "tiny", "entry": "train",
    "traffic": {"bridge_gain": 0.1, "batch": 4, "seq": 16, "shortest": 4, "pool": 5,
                "first_steps": 3,
                "trace_steps": 2, "steps_per_epoch": 100,
                "training": {"learning_rate": 1e-3, "min_lr": 1e-4, "weight_decay": 0.01,
                             "gradient_clip_val": 0.3, "num_epochs": 2,
                             "scheduler_type": "cosine"},
                "adam": {"beta1": 0.9, "beta2": 0.999, "eps": 1e-08}},
    # sound readings: loss <= 3e-4, grad <= 0.004, grad_err <= 0.03, change <= 0.027
    "checks": {"loss_gap": {"limit": 1.5e-3}, "grad_gap": {"limit": 0.02},
               "grad_err": {"limit": 0.08}, "change_gap": {"limit": 0.05}},
    "control": {"fp8": True},
}
CELLS = {"tiny-caption": CAPTION, "tiny-sampled": SAMPLED, "tiny-train": TRAIN}


def bench() -> dict:
    """A BENCHMARK.json naming the tiny cells, with the real metric names."""
    from portbench import spec

    real = spec.benchmark()
    cap = ["tiny-caption", "tiny-sampled"]

    def retarget(m):
        m = dict(m)
        if "workloads" in m:
            m["workloads"] = cap if any("caption" in w for w in m["workloads"]) else ["tiny-train"]
        return m

    return {**real, "workloads": [{"name": n, "config": "tiny", "traffic": n, "chips": 1,
                                   "why": "test"} for n in CELLS],
            "end_to_end": [retarget(m) for m in real["end_to_end"]],
            "per_layer": [retarget(m) for m in real["per_layer"]]}


def run(cell: str, seed: int = 6, seconds: float = 6.0, trace: bool = False, **kw) -> dict:
    import torch

    from portbench import run as runner

    spec = copy.deepcopy(CELLS[cell])
    spec["name"] = cell
    return runner.run(cell, seed, seconds, trace, torch.device("cpu"), bench=bench(),
                      spec=spec, cfg_file=CFG_FILE, **kw)
