"""The port's HF snapshot loader (vlm_bridge_tpu_torch.params.hf_loader)
against the `safetensors` package and the JAX package's hf_loader, on tiny
random `transformers` models built in memory (no download).

- The reader equals safetensors.torch.load_file bit for bit (six dtypes,
  odd element counts, __metadata__, two shards) and copies a misaligned
  tensor rather than viewing it at a misaligned address.
- Both converters equal the JAX converters' output carried through
  params/from_jax, bit for bit, in f32 and in bf16 (the SwiGLU variant and a
  `pos_embed_interp_{grid}` table at a grid other than native included).
- The port's forward on loaded weights is within f32 tolerance of the HF
  modules' (atol 3e-4, rtol 3e-3: the JAX parity tests' bounds).
- `--hf-vision-path` / `--hf-lm-path` through load_from_args and
  TrainingConfig.hf_* through init_params read save_pretrained snapshots.
"""

import dataclasses
import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlm_bridge_tpu.params import hf_loader as jhf
from vlm_bridge_tpu_torch import configs as tcfg
from vlm_bridge_tpu_torch.params import hf_loader as thf
from vlm_bridge_tpu_torch.params.from_jax import config_from_jax, from_jax
from vlm_bridge_tpu_torch.training.train_step import tree_leaves

safetensors_torch = pytest.importorskip("safetensors.torch")
transformers = pytest.importorskip("transformers")

FWD_TOL = dict(atol=3e-4, rtol=3e-3)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


def _same_tree(got, want):
    """Same keys, dtypes, shapes and bits."""
    assert isinstance(got, dict) == isinstance(want, dict)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same_tree(got[k], want[k])
        return
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))


# ---------------------------------------------------------------------------
# the reader
# ---------------------------------------------------------------------------


def test_reader_equals_the_safetensors_package(tmp_path):
    g = torch.Generator().manual_seed(0)
    shard1 = {"f32": torch.randn(3, 5, generator=g),
              "bf16": torch.randn(7, generator=g).to(torch.bfloat16),
              "f16": torch.randn(1, 3, 3, generator=g).to(torch.float16),
              "scalar": torch.tensor(1.5)}
    shard2 = {"i64": torch.randint(-2**40, 2**40, (5,), generator=g),
              "i32": torch.randint(-2**30, 2**30, (3, 3), generator=g, dtype=torch.int32),
              "u8": torch.randint(0, 256, (13,), generator=g, dtype=torch.uint8),
              "empty": torch.zeros(0, 4)}
    safetensors_torch.save_file(shard1, tmp_path / "model-00001-of-00002.safetensors",
                                metadata={"format": "pt"})
    safetensors_torch.save_file(shard2, tmp_path / "model-00002-of-00002.safetensors")
    (tmp_path / "model.safetensors.index.json").write_text("{}")   # not read
    got = thf.load_safetensors_dir(tmp_path)
    want = {**safetensors_torch.load_file(tmp_path / "model-00001-of-00002.safetensors"),
            **safetensors_torch.load_file(tmp_path / "model-00002-of-00002.safetensors")}
    assert sorted(got) == sorted(want) == sorted({**shard1, **shard2})
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(_bits(got[k]), _bits(want[k])), k
    with pytest.raises(FileNotFoundError):
        thf.load_safetensors_dir(tmp_path / "nothing")


def test_reader_copies_a_misaligned_tensor(tmp_path):
    """A file written by hand with a 3-byte U8 tensor before an F32 one: the
    F32 tensor's bytes start off a 4-byte boundary."""
    u8 = np.array([1, 2, 3], np.uint8)
    f32 = np.array([0.5, -2.25, 3e-8, np.inf], np.float32)
    header = {"__metadata__": {"note": "misaligned"},
              "a": {"dtype": "U8", "shape": [3], "data_offsets": [0, 3]},
              "b": {"dtype": "F32", "shape": [2, 2], "data_offsets": [3, 19]}}
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    path = tmp_path / "odd.safetensors"
    path.write_bytes(struct.pack("<Q", len(head)) + head + u8.tobytes() + f32.tobytes())
    got = thf.read_safetensors(path)
    assert got["b"].data_ptr() % 4 == 0
    np.testing.assert_array_equal(got["b"].numpy(), f32.reshape(2, 2))
    np.testing.assert_array_equal(got["a"].numpy(), u8)
    bad = dict(header, b={"dtype": "F32", "shape": [2, 3], "data_offsets": [3, 19]})
    head = json.dumps(bad).encode()
    path.write_bytes(struct.pack("<Q", len(head)) + head + u8.tobytes() + f32.tobytes())
    with pytest.raises(ValueError, match="spans bytes"):
        thf.read_safetensors(path)


# ---------------------------------------------------------------------------
# tiny HF models
# ---------------------------------------------------------------------------


def _hf_gemma2(seed=0):
    from transformers import Gemma2Config as HFConfig
    from transformers.models.gemma2.modeling_gemma2 import Gemma2ForCausalLM

    cfg = tcfg.Gemma2Config.tiny_test()
    hf_cfg = HFConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size, num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads, num_key_value_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, query_pre_attn_scalar=cfg.query_pre_attn_scalar,
        sliding_window=cfg.sliding_window, max_position_embeddings=cfg.max_position_embeddings,
        attn_implementation="eager")
    torch.manual_seed(seed)
    model = Gemma2ForCausalLM(hf_cfg).eval()
    with torch.no_grad():   # the init leaves the norms at zero: give them values
        for name, p in model.named_parameters():
            if "norm" in name:
                p.normal_(0, 0.1)
    return cfg, model


def _hf_dinov2(swiglu=False, seed=0):
    from transformers import Dinov2Config as HFConfig
    from transformers.models.dinov2.modeling_dinov2 import Dinov2Model

    cfg = dataclasses.replace(tcfg.DinoV2Config.tiny_test(), use_swiglu_ffn=swiglu)
    hf_cfg = HFConfig(
        hidden_size=cfg.hidden_size, num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads, mlp_ratio=cfg.mlp_ratio,
        image_size=cfg.image_size, patch_size=cfg.patch_size,
        layerscale_value=cfg.layerscale_value, use_swiglu_ffn=swiglu,
        attn_implementation="eager")
    torch.manual_seed(seed)
    model = Dinov2Model(hf_cfg).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "layer_scale" in name or name.endswith("bias"):
                p.normal_(0, 0.1)
    return cfg, model


@pytest.fixture(scope="module")
def gemma():
    return _hf_gemma2()


@pytest.fixture(scope="module")
def dino():
    return _hf_dinov2()


def _jax_to_port(tree):
    return from_jax(jax.tree.map(np.asarray, tree))


# ---------------------------------------------------------------------------
# converters against the JAX converters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gemma2_converter_equals_jax(gemma, dtype):
    cfg, model = gemma
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    sd = model.state_dict()
    want = _jax_to_port(jhf.gemma2_from_state_dict(sd, _jax_config(cfg), dtype=jd))
    got = thf.gemma2_from_state_dict(sd, cfg, dtype=td)
    _same_tree(got, want)
    # the same from a Gemma2Model state dict (no "model." prefix)
    _same_tree(thf.gemma2_from_state_dict(model.model.state_dict(), cfg, dtype=td), want)


def _jax_config(cfg):
    """The JAX package's config of the same values (the converters take the
    package's own class)."""
    from vlm_bridge_tpu import configs as jcfg

    return getattr(jcfg, type(cfg).__name__)(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("swiglu", [False, True], ids=["gelu_mlp", "swiglu"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dinov2_converter_equals_jax(swiglu, dtype):
    cfg, model = _hf_dinov2(swiglu=swiglu, seed=1)
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    sd = model.state_dict()
    grids = (3, cfg.native_grid, 16)   # the native grid gets no table
    want = _jax_to_port(jhf.dinov2_from_state_dict(sd, _jax_config(cfg), dtype=jd,
                                                   target_grids=grids))
    got = thf.dinov2_from_state_dict(sd, cfg, dtype=td, target_grids=grids)
    assert {k for k in got if k.startswith("pos_embed_interp_")} == {"pos_embed_interp_3",
                                                                     "pos_embed_interp_16"}
    _same_tree(got, want)
    assert config_from_jax(_jax_config(cfg)) == cfg


def test_pos_embed_interp_is_torch_bicubic_on_the_host(dino):
    """The table is HF's interpolate_pos_encoding resize: torch's A = -0.75
    bicubic in f32, here at grid 3 (native 5), against
    F.interpolate called directly."""
    cfg, model = dino
    pos = model.embeddings.position_embeddings.detach()
    table = thf._torch_bicubic_pos_interp(pos, 3)
    n, h = cfg.native_grid, cfg.hidden_size
    want = torch.nn.functional.interpolate(
        pos[:, 1:].reshape(1, n, n, h).permute(0, 3, 1, 2), size=(3, 3), mode="bicubic",
        align_corners=False).permute(0, 2, 3, 1).reshape(1, 9, h)
    assert table.dtype == torch.float32 and table.device.type == "cpu"
    assert torch.equal(table[:, 1:], want) and torch.equal(table[:, :1], pos[:, :1])
    np.testing.assert_array_equal(
        table.numpy(), jhf._torch_bicubic_pos_interp(pos.numpy(), 3))


# ---------------------------------------------------------------------------
# the port's forward on loaded weights against the HF modules
# ---------------------------------------------------------------------------


def test_gemma2_forward_on_loaded_weights_matches_hf(gemma):
    from vlm_bridge_tpu_torch.models import gemma2

    cfg, model = gemma
    params = thf.gemma2_from_state_dict(model.state_dict(), cfg, dtype=torch.float32)
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 24)))
    with torch.no_grad():
        want = model(input_ids=ids).logits
        got = gemma2.forward(params, cfg, input_ids=ids,
                             attn_mask=torch.ones(2, 24, dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **FWD_TOL)


@pytest.mark.parametrize("size", [70, 42], ids=["native_grid", "grid_3"])
def test_dinov2_forward_on_loaded_weights_matches_hf(dino, size):
    from vlm_bridge_tpu_torch.models import dinov2

    cfg, model = dino
    params = thf.dinov2_from_state_dict(model.state_dict(), cfg, dtype=torch.float32,
                                        target_grids=(size // cfg.patch_size,))
    x = np.random.default_rng(2).normal(0, 1, (2, size, size, 3)).astype(np.float32)
    with torch.no_grad():
        want = model(pixel_values=torch.from_numpy(x.transpose(0, 3, 1, 2))).last_hidden_state
        got = dinov2.forward(params, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **FWD_TOL)


def test_swiglu_forward_on_loaded_weights_matches_hf():
    from vlm_bridge_tpu_torch.models import dinov2

    cfg, model = _hf_dinov2(swiglu=True, seed=1)
    assert model.encoder.layer[0].mlp.weights_out.in_features == cfg.swiglu_hidden
    params = thf.dinov2_from_state_dict(model.state_dict(), cfg, dtype=torch.float32,
                                        target_grids=())
    x = np.random.default_rng(0).normal(0, 1, (2, cfg.image_size, cfg.image_size, 3))
    x = x.astype(np.float32)
    with torch.no_grad():
        want = model(pixel_values=torch.from_numpy(x.transpose(0, 3, 1, 2))).last_hidden_state
        got = dinov2.forward(params, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **FWD_TOL)


# ---------------------------------------------------------------------------
# snapshots through the CLIs' loading and the trainer's init
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory, gemma, dino):
    root = tmp_path_factory.mktemp("hf")
    _, lm = gemma
    _, vision = dino
    lm.save_pretrained(root / "gemma", safe_serialization=True, max_shard_size="150KB")
    vision.save_pretrained(root / "dino", safe_serialization=True)
    assert len(list((root / "gemma").glob("*.safetensors"))) > 1   # sharded, with an index
    assert (root / "gemma" / "model.safetensors.index.json").exists()
    return root / "dino", root / "gemma"


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_hf_paths_through_load_from_args(snapshots, gemma, dino, dtype):
    import argparse

    from vlm_bridge_tpu_torch.tools.loading import add_model_args, load_from_args

    vpath, lpath = snapshots
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    ap = argparse.ArgumentParser()
    add_model_args(ap)
    args = ap.parse_args(["--preset", "tiny", "--device", "cpu", "--dtype", dtype,
                          "--hf-vision-path", str(vpath), "--hf-lm-path", str(lpath)])
    cfg, params, _ = load_from_args(args)
    grid = cfg.image_size // cfg.vision.patch_size
    _same_tree(params["lm"], thf.gemma2_from_state_dict(gemma[1].state_dict(), cfg.lm, td))
    _same_tree(params["vision"], thf.dinov2_from_state_dict(
        dino[1].state_dict(), cfg.vision, td, target_grids=(grid,)))
    # the quantized recipe quantizes the loaded weights
    args = ap.parse_args(["--preset", "tiny", "--device", "cpu", "--hf-lm-path", str(lpath),
                          "--quantize", "embedding,mlp,attn"])
    _, q, _ = load_from_args(args)
    assert isinstance(q["lm"]["layers"]["0"]["mlp"]["gate"], dict)
    _same_tree(q["lm"]["final_norm"], params["lm"]["final_norm"].to(torch.bfloat16))


def test_hf_paths_through_init_params(snapshots, gemma, dino):
    from vlm_bridge_tpu_torch.training.stack import init_params

    vpath, lpath = snapshots
    tc = tcfg.TrainingConfig(model_preset="tiny_test", hf_vision_path=str(vpath),
                             hf_lm_path=str(lpath), seed=5)
    cfg = tc.model_config()
    params = init_params(tc, frozen_dtype=torch.float32, device="cpu")
    _same_tree(params["lm"], thf.gemma2_from_state_dict(gemma[1].state_dict(), cfg.lm,
                                                        torch.float32))
    _same_tree(params["vision"], thf.dinov2_from_state_dict(
        dino[1].state_dict(), cfg.vision, torch.float32,
        target_grids=(cfg.image_size // cfg.vision.patch_size,)))
    # the bridge is the seeded init, untouched by the snapshots
    plain = init_params(tcfg.TrainingConfig(model_preset="tiny_test", seed=5),
                        frozen_dtype=torch.float32, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params["bridge"]),
                                                 tree_leaves(plain["bridge"])))


@pytest.mark.parametrize("pad,cleanup", [(True, False), (False, True)],
                         ids=["pad_token", "pad_is_eos_cleanup"])
def test_gemma_tokenizer_equals_the_jax_packages(tmp_path, pad, cleanup):
    """The port's GemmaTokenizer (tokenizer.json through `tokenizers`, no
    transformers) against the JAX package's (AutoTokenizer) on a tiny
    snapshot saved by transformers: special ids, vocab size, encode with and
    without truncation, decode."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors
    from transformers import PreTrainedTokenizerFast

    from vlm_bridge_tpu.data.tokenizer import GemmaTokenizer as JGemma
    from vlm_bridge_tpu_torch.data.tokenizer import GemmaTokenizer, get_tokenizer

    words = "a cat dog on the mat sat . , ! ? red".split()
    vocab = {"<pad>": 0, "<eos>": 1, "<bos>": 2, "<unk>": 3,
             **{w: i + 4 for i, w in enumerate(words)}}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.post_processor = processors.TemplateProcessing(single="<bos> $A",
                                                       special_tokens=[("<bos>", 2)])
    kw = dict(bos_token="<bos>", eos_token="<eos>", unk_token="<unk>",
              clean_up_tokenization_spaces=cleanup)
    if pad:
        kw["pad_token"] = "<pad>"
    PreTrainedTokenizerFast(tokenizer_object=tok, **kw).save_pretrained(tmp_path)
    want, got = JGemma(tmp_path), get_tokenizer(str(tmp_path))
    assert isinstance(got, GemmaTokenizer)
    assert (got.pad_token_id, got.eos_token_id, got.bos_token_id, got.vocab_size) == \
        (want.pad_token_id, want.eos_token_id, want.bos_token_id, want.vocab_size)
    for text in ("a cat sat on the mat .", "red dog , zebra !", ""):
        for max_length in (None, 3):
            ids = got.encode(text, max_length=max_length)
            assert ids == want.encode(text, max_length=max_length)
        assert got.decode(ids + [1, 0]) == want.decode(ids + [1, 0])
        full = got.encode(text)
        assert got.decode(full) == want.decode(full)
