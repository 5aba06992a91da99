"""PyTorch port hygiene: the port and chip_smoke.py import no JAX and nothing
of the JAX package, the port's own copies of the configs and the tokenizer
equal the JAX package's, the smoke script refuses to run without a GPU, and
every kernel wrapper given CPU tensors returns its plain version's result
without counting a launch."""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
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
    assert {"vlm_bridge_tpu_torch.ops.sampling", "vlm_bridge_tpu_torch.inference.robust",
            "vlm_bridge_tpu_torch.inference.evaluate", "vlm_bridge_tpu_torch.inference.metrics",
            "vlm_bridge_tpu_torch.data.loader", "vlm_bridge_tpu_torch.data.groundcap",
            "vlm_bridge_tpu_torch.data.pixel_cache", "vlm_bridge_tpu_torch.ops.matmul_kernels",
            "vlm_bridge_tpu_torch.ops.norm_kernels"} <= set(mods)
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


def _port_files():
    return (sorted((REPO / "vlm_bridge_tpu_torch").rglob("*.py"))
            + [REPO / "chip_smoke.py", REPO / "scripts" / "profile_train_torch.py",
               REPO / "scripts" / "int8_linear_torch.py",
               REPO / "scripts" / "vit_ab_torch.py",
               REPO / "scripts" / "flash_fwd_torch.py", REPO / "scripts" / "flash_bwd_torch.py",
               REPO / "scripts" / "tiled_matmul_torch.py",
               REPO / "scripts" / "decode_gemm_torch.py", REPO / "scripts" / "head_torch.py"])


def test_no_import_of_jax_or_the_jax_package():
    """An ast walk over every source file of the port, chip_smoke.py and the
    port's profiling script: no
    import names `jax` or `vlm_bridge_tpu` (`vlm_bridge_tpu_torch` is the
    port itself), at module level or inside a function."""
    banned = ("jax", "vlm_bridge_tpu", "flax", "optax")
    files = _port_files()
    assert len(files) > 20
    assert {"sampling.py", "robust.py"} <= {p.name for p in files}
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in banned, f"{path}:{node.lineno} imports {name}"


PRESETS = [(cls, preset)
           for cls, presets in (
               ("DinoV2Config", ("large", "base", "giant", "tiny_test")),
               ("Gemma2Config", ("gemma2_2b", "gemma2_9b", "gemma2_27b", "tiny_test")),
               ("BridgeConfig", ("default", "tiny_test")),
               ("VLMConfig", ("default", "gemma2_9b", "gemma2_27b", "tiny_test", "tiny_ref")))
           for preset in presets]


@pytest.mark.parametrize("cls,preset", PRESETS, ids=[f"{c}.{p}" for c, p in PRESETS])
def test_config_presets_equal_the_jax_package(cls, preset):
    from vlm_bridge_tpu import configs as jcfg
    from vlm_bridge_tpu_torch import configs as tcfg
    from vlm_bridge_tpu_torch.params.from_jax import config_from_jax

    want, got = getattr(getattr(jcfg, cls), preset)(), getattr(getattr(tcfg, cls), preset)()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    assert config_from_jax(want) == got and type(config_from_jax(want)) is type(got)
    # every preset of the JAX class is listed above
    listed = {p for c, p in PRESETS if c == cls}
    statics = {n for n, v in vars(getattr(jcfg, cls)).items() if isinstance(v, staticmethod)}
    assert statics == listed
    for prop in ("head_dim", "native_grid", "swiglu_hidden", "attn_scale", "num_vision_tokens"):
        if hasattr(want, prop):
            assert getattr(got, prop) == getattr(want, prop)
    if cls == "Gemma2Config":
        assert [got.layer_is_sliding(i) for i in range(4)] == [want.layer_is_sliding(i)
                                                               for i in range(4)]


@pytest.mark.parametrize("preset", ["default", "tiny_test", "tiny_test_wide", "gemma2_9b",
                                    "gemma2_27b"])
def test_training_config_equal_the_jax_package(preset, tmp_path):
    from vlm_bridge_tpu import configs as jcfg
    from vlm_bridge_tpu_torch import configs as tcfg

    assert dataclasses.asdict(tcfg.TrainingConfig()) == dataclasses.asdict(jcfg.TrainingConfig())
    kw = dict(model_preset=preset, batch_size=3, pad_to_buckets=(32, 64), scheduler_type="linear")
    want, got = jcfg.TrainingConfig(**kw), tcfg.TrainingConfig(**kw)
    assert dataclasses.asdict(got.model_config()) == dataclasses.asdict(want.model_config())
    # one YAML file serves both packages, in both directions
    want.to_yaml(tmp_path / "jax.yaml")
    got.to_yaml(tmp_path / "port.yaml")
    assert (tmp_path / "jax.yaml").read_text() == (tmp_path / "port.yaml").read_text()
    assert dataclasses.asdict(tcfg.TrainingConfig.from_yaml(tmp_path / "jax.yaml")) == \
        dataclasses.asdict(jcfg.TrainingConfig.from_yaml(tmp_path / "port.yaml")) == \
        dataclasses.asdict(want)
    assert tcfg.TrainingConfig.from_yaml(tmp_path / "missing.yaml") == tcfg.TrainingConfig()
    with pytest.raises(ValueError, match="model_preset"):
        tcfg.TrainingConfig(model_preset="nope").model_config()
    for path in sorted((REPO / "config").glob("*.yaml")):
        assert dataclasses.asdict(tcfg.TrainingConfig.from_yaml(path)) == \
            dataclasses.asdict(jcfg.TrainingConfig.from_yaml(path))


def test_tokenizer_copy_equals_the_jax_package():
    from vlm_bridge_tpu.data import tokenizer as jtok
    from vlm_bridge_tpu_torch.data import tokenizer as ttok

    public = lambda m: sorted(n for n in vars(m) if not n.startswith("_"))  # noqa: E731
    assert public(ttok) == public(jtok)
    a, b = jtok.get_tokenizer(None), ttok.get_tokenizer(None)
    assert type(a).__name__ == type(b).__name__ == "ByteTokenizer"
    texts = ["a cat on a mat", "", "naïve café ☕", "x" * 300]
    for text in texts:
        for max_length in (None, 16):
            ids = b.encode(text, max_length=max_length)
            assert ids == a.encode(text, max_length=max_length)
            assert b.decode(ids) == a.decode(ids)
    for kw in (dict(max_length=40), dict(max_length=512, buckets=(64, 128, 512)),
               dict(max_length=40, append_eos=False)):
        ja, jm = jtok.batch_encode(a, texts, **kw)
        ta, tm = ttok.batch_encode(b, texts, **kw)
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tm, jm)
    assert (b.pad_token_id, b.eos_token_id, b.bos_token_id, b.vocab_size) == \
        (a.pad_token_id, a.eos_token_id, a.bos_token_id, a.vocab_size)


def test_chip_smoke_refuses_without_gpu():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                         text=True, timeout=60, env=env)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_wrappers_on_cpu_take_plain_path_and_count_nothing():
    from vlm_bridge_tpu_torch.configs import BridgeConfig, Gemma2Config
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


def test_flash_wrappers_on_cpu_take_plain_path_and_count_nothing(monkeypatch):
    from vlm_bridge_tpu_torch.ops import cuda_lib
    from vlm_bridge_tpu_torch.ops import flash_attention as fa

    monkeypatch.setattr(cuda_lib, "lib", lambda: pytest.fail("a CPU tensor built the kernels"))
    counted = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkv)
    before = [fn.launches for fn in counted]
    g = torch.Generator().manual_seed(0)
    q, do = torch.randn(2, 5, 4, 64, generator=g), torch.randn(2, 5, 4, 64, generator=g)
    k, v = torch.randn(2, 7, 2, 64, generator=g), torch.randn(2, 7, 2, 64, generator=g)
    lens = torch.tensor([7, 3], dtype=torch.int32)
    kw = dict(scale=0.125, is_causal=True, logit_softcap=50.0, sliding_window=4)
    out, lse = fa.flash_attention_fwd(q, k, v, lens, **kw)
    out_p, lse_p = fa.flash_attention_plain(q, k, v, lens, **kw)
    assert torch.equal(out, out_p) and torch.equal(lse, lse_p)
    dq_p, dk_p, dv_p = fa.flash_attention_bwd_plain(q, k, v, lens, out, lse, do, **kw)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, lens, out, lse, do, **kw)
    assert torch.equal(dq, dq_p) and torch.equal(delta, fa._delta(out, do))
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lens, out, lse, do, **kw)
    assert torch.equal(dk, dk_p) and torch.equal(dv, dv_p)
    assert [fn.launches for fn in counted] == before


def test_vit_wrappers_on_cpu_take_plain_path_and_count_nothing(monkeypatch):
    from vlm_bridge_tpu_torch.ops import cuda_lib
    from vlm_bridge_tpu_torch.ops import matmul_kernels as mk
    from vlm_bridge_tpu_torch.ops import norm_kernels as nk

    monkeypatch.setattr(cuda_lib, "lib", lambda: pytest.fail("a CPU tensor built the kernels"))
    before = (mk.tiled_matmul.launches, mk.tiled_matmul.bias_launches, nk.layer_norm_fast.launches)
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(9, 12, generator=g), torch.randn(12, 10, generator=g)   # widths no kernel takes
    bias = torch.randn(10, generator=g)
    for kw in (dict(), dict(gelu=True), dict(out_dtype=torch.bfloat16)):
        assert torch.equal(mk.tiled_matmul(a, b, bias, **kw), mk.tiled_matmul_plain(a, b, bias, **kw))
    assert torch.equal(mk.tiled_matmul(a, b), mk.tiled_matmul_plain(a, b))
    torch.testing.assert_close(mk.tiled_matmul(a, b, bias, gelu=True),
                               torch.nn.functional.gelu(a @ b + bias))
    x, s, c = torch.randn(5, 12, generator=g), torch.randn(12, generator=g), torch.randn(12, generator=g)
    assert torch.equal(nk.layer_norm_fast(x, s, c, 1e-6), nk.layer_norm_fast_plain(x, s, c, 1e-6))
    torch.testing.assert_close(nk.layer_norm_fast(x, s, c, 1e-6),
                               torch.nn.functional.layer_norm(x, (12,), s, c, 1e-6))
    assert (mk.tiled_matmul.launches, mk.tiled_matmul.bias_launches,
            nk.layer_norm_fast.launches) == before


def test_kernel_sources_ship_and_name_what_they_replace():
    csrc = REPO / "vlm_bridge_tpu_torch" / "csrc"
    replaced = {"stack_step.cu": "decode_kernels.py:fused_stack_step",
                "bridge_step.cu": "decode_kernels.py:fused_bridge_step",
                "tied_head.cu": "quant.py:int8_matmul_t_argmax",
                "int8_linear.cu": "quant.py:int8_matmul",
                "flash_fwd.cu": "flash_attention.py:_flash_fwd",
                "layer_step.cu": "decode_kernels.py:fused_attn_step",
                "tiled_matmul.cu": "matmul_kernels.py:_tiled_matmul_jit",
                "layer_norm.cu": "norm_kernels.py:_ln_forward"}
    for name, target in replaced.items():
        text = (csrc / name).read_text()
        assert f"Replaces: vlm_bridge_tpu/ops/{target}" in text
        assert "Bound:" in text
    fa_bwd = (csrc / "flash_bwd.cu").read_text()
    assert "vlm_bridge_tpu/ops/flash_attention.py:_flash_bwd" in fa_bwd and "Bound:" in fa_bwd
    assert not (csrc / "flash_attention.cu").exists()   # the mma.sync backward is gone
    assert not (csrc / "int8_argmax.cu").exists()   # so are the wmma / mma.sync logits tiles
    assert not (csrc / "int4_linear.cu").exists()   # and the mma.sync int4 MLP
    assert "vlm_bridge_tpu/ops/decode_kernels.py:fused_mlp_step" in \
        (csrc / "layer_step.cu").read_text()
    for target in ("quant.py:int8_mlp", "quant.py:int8_ffn"):
        assert f"vlm_bridge_tpu/ops/{target}" in (csrc / "int8_linear.cu").read_text()
    assert "Replaces: vlm_bridge_tpu/ops/quant.py:int4_mlp" in (csrc / "int8_linear.cu").read_text()
    heads = (csrc / "tied_head.cu").read_text()
    for target in ("int8_matmul_t,", "int4_matmul_t,", "int4_matmul_t_argmax,"):
        assert f"Replaces: vlm_bridge_tpu/ops/quant.py:{target}" in heads
    assert "Bound: bytes." in heads and "65.5 MB of logits" in heads
    i4 = (csrc / "i4_gemm.cu").read_text()
    assert "vlm_bridge_tpu/ops/decode_kernels.py:_stack_kernel" in i4 and "Bound:" in i4
    from vlm_bridge_tpu_torch.ops import cuda_lib

    assert {p.name for p in cuda_lib._sources()} >= set(replaced) | {
        "flash_bwd.cu", "i8_gemm.cu", "i4_gemm.cu", "common.cuh", "linear_common.cuh",
        "sm90.cuh"}
    assert np.isin(["-gencode", "arch=compute_90a,code=sm_90a"], cuda_lib.NVCC_FLAGS).all()
    for entry, src in (("vbt_flash_attention_fwd", "flash_fwd.cu"),
                       ("vbt_flash_attention_bwd_dq", "flash_bwd.cu"),
                       ("vbt_flash_attention_bwd_dkv", "flash_bwd.cu")):
        assert entry in cuda_lib.SIGNATURES
        assert f'extern "C" int {entry}(' in (csrc / src).read_text()
    for entry, src in (("vbt_int8_matmul", "int8_linear.cu"), ("vbt_int8_mlp", "int8_linear.cu"),
                       ("vbt_int8_ffn", "int8_linear.cu"),
                       ("vbt_int8_matmul_t", "tied_head.cu"),
                       ("vbt_int4_matmul_t", "tied_head.cu"),
                       ("vbt_int8_matmul_t_argmax", "tied_head.cu"),
                       ("vbt_int4_matmul_t_argmax", "tied_head.cu"),
                       ("vbt_int4_mlp", "int8_linear.cu"),
                       ("vbt_fused_stack_step", "stack_step.cu"),
                       ("vbt_fused_attn_step", "layer_step.cu"),
                       ("vbt_fused_mlp_step", "layer_step.cu"),
                       ("vbt_tiled_matmul", "tiled_matmul.cu"),
                       ("vbt_layer_norm", "layer_norm.cu")):
        assert entry in cuda_lib.SIGNATURES
        assert f'extern "C" int {entry}(' in (csrc / src).read_text()
