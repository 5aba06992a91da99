"""PyTorch port hygiene: the port and chip_smoke.py import no JAX, the smoke
script refuses to run without a GPU, and every kernel wrapper given CPU
tensors returns its plain version's result without counting a launch."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]


def _port_modules():
    pkg = REPO / "vlm_bridge_tpu_torch"
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in pkg.rglob("*.py"))


def test_port_imports_without_jax():
    mods = _port_modules()
    assert "vlm_bridge_tpu_torch.ops.decode_kernels" in mods
    code = ("import sys; sys.modules['jax'] = None\n"
            "import importlib\n"
            f"for m in {mods!r} + ['chip_smoke']:\n"
            "    importlib.import_module(m)\n"
            "assert not any(k == 'jax' or k.startswith('jax.') for k, v in sys.modules.items()"
            " if v is not None)\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120, env=env)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_chip_smoke_refuses_without_gpu():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                         text=True, timeout=60, env=env)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_wrappers_on_cpu_take_plain_path_and_count_nothing():
    from vlm_bridge_tpu.configs import BridgeConfig, Gemma2Config
    from vlm_bridge_tpu_torch.inference.generate import _build_cross_cache
    from vlm_bridge_tpu_torch.models import bridge, gemma2
    from vlm_bridge_tpu_torch.ops import decode_kernels as dk
    from vlm_bridge_tpu_torch.ops import quant

    counted = (dk.fused_stack_step, dk.fused_bridge_step, quant.int8_matmul_t_argmax)
    before = [fn.launches for fn in counted]
    g = torch.Generator().manual_seed(0)

    lm = Gemma2Config(vocab_size=300, hidden_size=64, intermediate_size=128, num_layers=2,
                      num_heads=4, num_kv_heads=2, head_dim=16, sliding_window=128)
    q = gemma2.quantize_params(gemma2.init(lm, generator=g, dtype=torch.float32))
    st = gemma2.stack_decode_params(q, lm)
    x = torch.randn(3, 64, generator=g)
    kw = dict(num_heads=4, num_kv_heads=2, head_dim=16, attn_scale=0.25, softcap=50.0,
              eps=1e-6)
    cos, sin = torch.ones(16), torch.zeros(16)
    outs = []
    for fn in (dk.fused_stack_step, dk.fused_stack_step_plain):
        c = gemma2.StackedKVCache.zeros(lm, 3, 4)
        outs.append(fn(1, x, st, *c, cos, sin, **kw))
    assert torch.equal(outs[0], outs[1])

    bc = BridgeConfig.tiny_test()
    bq = bridge.quantize_decode_params(bridge.init(bc, generator=g))
    bst = bridge.stack_bridge_decode_params(bq, bc)
    vision = torch.randn(3, 5, bc.vision_dim, generator=g)
    y = torch.randn(3, bc.language_dim, generator=g)
    outs = []
    for fn in (dk.fused_bridge_step, dk.fused_bridge_step_plain):
        c = _build_cross_cache(bq, bc, vision, 4, torch.float32, kv_quant=True)
        outs.append(fn(0, y, bst, c.cross_k, c.cross_k_scale, c.cross_v, c.cross_v_scale,
                       c.self_k, c.self_v, num_heads_cross=bc.num_heads_cross,
                       num_heads_self=bc.num_heads_self, eps=bc.layer_norm_eps))
    assert torch.equal(outs[0], outs[1])

    h = torch.randn(3, 64, generator=g)
    assert torch.equal(quant.int8_matmul_t_argmax(h, q["embedding"]),
                       quant.int8_matmul_t_argmax_plain(h, q["embedding"]))
    assert [fn.launches for fn in counted] == before


def test_kernel_sources_ship_and_name_what_they_replace():
    csrc = REPO / "vlm_bridge_tpu_torch" / "csrc"
    replaced = {"stack_step.cu": "decode_kernels.py:fused_stack_step",
                "bridge_step.cu": "decode_kernels.py:fused_bridge_step",
                "int8_argmax.cu": "quant.py:int8_matmul_t_argmax"}
    for name, target in replaced.items():
        text = (csrc / name).read_text()
        assert f"Replaces: vlm_bridge_tpu/ops/{target}" in text
        assert "Bound:" in text
    from vlm_bridge_tpu_torch.ops import cuda_lib

    assert {p.name for p in cuda_lib._sources()} >= set(replaced) | {"i8_gemm.cu",
                                                                     "common.cuh"}
    assert np.isin(["-gencode", "arch=compute_90a,code=sm_90a"], cuda_lib.NVCC_FLAGS).all()
