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
    port itself), nor `safetensors` or `transformers` (the card's machine has
    neither: the HF loader reads the format itself), at module level or
    inside a function."""
    banned = ("jax", "vlm_bridge_tpu", "flax", "optax", "safetensors", "transformers")
    files = _port_files()
    assert len(files) > 20
    assert {"sampling.py", "robust.py"} <= {p.name for p in files}
    port = REPO / "vlm_bridge_tpu_torch"
    assert {port / rel for rel in ("params/hf_loader.py", "tools/debug_generation.py",
                                   "tools/parity.py", "parallel/distributed.py",
                                   "parallel/sharding.py", "parallel/__init__.py",
                                   "entry.py")} <= set(files)
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


def _defined_names(path: Path) -> set:
    """Public names a module defines at its top level (functions, classes,
    assignments), from its source."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
    return {n for n in out if not n.startswith("_")}


# what the port does not have, and why: ROADMAP.md's "Not to port" (JAX
# compile and TPU tiling levers, interpret-mode switches, host_rtt,
# apply_platform). Every module is ported, tensor parallelism of the frozen
# LM included (tests/test_torch_tensor_parallel.py).
UNPORTED_MODULES = set()
UNPORTED_NAMES = {
    "tools/loading.py": {"apply_platform"},
    "models/gemma2.py": {"stack_layers_for_scan", "unstack_scan_layers"},
    "ops/decode_kernels.py": {"ATTN_MODE", "INTERPRET", "stack_mlp_block_f"},
    "ops/flash_attention.py": {"DEFAULT_BLOCK_K", "DEFAULT_BLOCK_Q", "INTERPRET",
                               "maybe_flash_attention"},
    "ops/matmul_kernels.py": {"DEFAULT_BLOCK_M", "DEFAULT_BLOCK_N", "INTERPRET"},
    "ops/norm_kernels.py": {"INTERPRET"},
    "ops/quant.py": {"INTERPRET"},
    "runtime/profiling.py": {"host_rtt"},
}


def _public_params(path: Path) -> dict:
    """{public top-level function: its parameter names} of a module, from its
    source."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                not node.name.startswith("_"):
            a = node.args
            out[node.name] = {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs} | {
                f"*{x.arg}" for x in (a.vararg, a.kwarg) if x is not None}
    return out


# the JAX parameters the port's functions do not take, by design: `rng` (a
# torch.Generator, `generator=`, in its place), the TPU tiling levers
# `block_*`, stack_decode_params' 16 GB measure `free_layers`, JAX's device
# lists and batch ranks of the mesh helpers (`devices`, `ndim`: one process
# a place, batch_sharding returns a row slice), and build_memorization_dataset's
# `image_size` (the port writes the pixel cache at the crop size)
UNPORTED_PARAMS = {
    "inference/caption.py": {"caption_images": {"rng"}},
    "inference/evaluate.py": {"evaluate_split": {"rng"}},
    "inference/generate.py": {"generate_tokens": {"rng"}},
    "inference/robust.py": {"generate_caption_robust": {"rng"}},
    "models/bridge.py": {"init": {"rng"}, "forward": {"rng"}},
    "models/dinov2.py": {"init": {"rng"}},
    "models/full_model.py": {"init": {"rng"}, "bridge_text": {"rng"}, "forward": {"rng"}},
    "models/gemma2.py": {"init": {"rng"}, "stack_decode_params": {"free_layers"}},
    "ops/decode_kernels.py": {"fused_stack_step": {"block_f", "block_proj"},
                              "fused_mlp_step": {"block_f"}, "fused_bridge_step": {"block_f"}},
    "ops/flash_attention.py": {"flash_attention": {"block_k", "block_q"}},
    "ops/matmul_kernels.py": {"tiled_matmul": {"block_m", "block_n"}},
    "ops/quant.py": {"int8_matmul": {"block_i", "block_o"}, "int8_matmul_t": {"block_v"},
                     "int8_matmul_t_argmax": {"block_v"}, "int4_matmul_t": {"block_v"},
                     "int4_matmul_t_argmax": {"block_v"}, "int8_mlp": {"block_f"},
                     "int8_ffn": {"block_f"}},
    "ops/sampling.py": {"sample_token": {"rng"}},
    "parallel/sharding.py": {"auto_mesh": {"devices"}, "batch_sharding": {"ndim"}},
    "tools/memorize.py": {"build_memorization_dataset": {"image_size"}},
    "training/stack.py": {"build_mesh": {"devices"}},
}


def test_public_params_walk_finds_only_the_by_design_ones():
    """Every public function the port shares with the JAX package takes every
    parameter the JAX one takes, but for UNPORTED_PARAMS (so a missing
    `mesh=` cannot pass again: it is on no list)."""
    jax_pkg, port = REPO / "vlm_bridge_tpu", REPO / "vlm_bridge_tpu_torch"
    missing = {}
    for jpath in sorted(jax_pkg.rglob("*.py")):
        rel = jpath.relative_to(jax_pkg).as_posix()
        tpath = port / rel
        if jpath.name == "__init__.py" or not tpath.exists():
            continue
        theirs, ours = _public_params(jpath), _public_params(tpath)
        gone = {f: ps - ours[f] for f, ps in theirs.items() if f in ours and ps - ours[f]}
        if gone:
            missing[rel] = gone
    assert missing == UNPORTED_PARAMS
    assert not any("mesh" in ps for funcs in UNPORTED_PARAMS.values() for ps in funcs.values())


def test_public_names_walk_finds_only_the_deferred_ones():
    """Every module of the JAX package has its counterpart at the same path
    in the port, with every public name it defines, but for the modules and
    names listed above; and every port module is one `_port_files` walks."""
    jax_pkg, port = REPO / "vlm_bridge_tpu", REPO / "vlm_bridge_tpu_torch"
    missing_modules, missing_names = set(), {}
    for jpath in sorted(jax_pkg.rglob("*.py")):
        if jpath.name == "__init__.py":
            continue
        rel = jpath.relative_to(jax_pkg).as_posix()
        tpath = port / rel
        if not tpath.exists():
            missing_modules.add(rel)
            continue
        gone = _defined_names(jpath) - _defined_names(tpath)
        if gone:
            missing_names[rel] = gone
    assert missing_modules == UNPORTED_MODULES
    assert missing_names == UNPORTED_NAMES
    walked = set(_port_files())
    for rel in ("training/orchestrator.py", "training/stack.py", "training/cli.py",
                "runtime/checkpoint.py", "runtime/tb_writer.py", "runtime/profiling.py",
                "params/torch_bridge.py", "data/cli.py", "tools/convert.py",
                "tools/memorize.py", "params/hf_loader.py", "tools/debug_generation.py",
                "tools/parity.py", "parallel/distributed.py", "parallel/sharding.py",
                "entry.py"):
        assert port / rel in walked, rel


def test_tb_writer_copy_writes_the_jax_modules_bytes(tmp_path, monkeypatch):
    import time

    from vlm_bridge_tpu.runtime import tb_writer as jtb
    from vlm_bridge_tpu_torch.runtime import tb_writer as ttb

    public = lambda m: sorted(n for n in vars(m) if not n.startswith("_"))  # noqa: E731
    assert public(ttb) == public(jtb)
    monkeypatch.setattr(time, "time", lambda: 1760000000.25)
    files = []
    for mod, name in ((jtb, "jax"), (ttb, "port")):
        w = mod.SummaryWriter(tmp_path / name)
        w.add_scalar("train/loss", 5.5, 1)
        w.add_scalar("train/loss", float("nan"), 2, wall_time=1.5)
        w.add_scalar("val/perplexity", 1e30, 2 ** 40)
        w.add_text("val/sample_0", "**generated:** naïve café ☕\n\n**bleu4:** 0.1", 3)
        w.add_text("config", "", 0)
        w.close()
        (f,) = list((tmp_path / name).glob("events.out.tfevents.*"))
        files.append(f)
    assert files[0].name == files[1].name
    assert files[0].read_bytes() == files[1].read_bytes()
    got, want = ttb.read_scalars(files[1]), jtb.read_scalars(files[0])
    assert list(got) == list(want) == ["train/loss", "val/perplexity"]
    assert got["val/perplexity"] == want["val/perplexity"]
    assert list(ttb.read_events(files[0])) == list(jtb.read_events(files[1]))
    ttb.NullWriter().add_scalar("x", 1.0, 0)
