"""PyTorch port, the batched eval harness on the CPU, held to the JAX package:

- `inference.metrics` and the data modules (`data.groundcap`,
  `data.pixel_cache`, `data.loader`) are the port's own copies: the same
  public names, and the same outputs on the same inputs (files, manifests,
  fingerprints, batches);
- `evaluate_split` over one `make_synthetic_dataset` split gives the JAX
  `evaluate_split`'s captions and metrics (BLEU / CIDEr to 1e-6), with float
  weights on the per-layer path and with the int8 recipe on the fused path,
  with `max_samples` and with a padded last batch;
- the `vlm-eval-torch` CLI on the CPU: the int4 head, `--sample` under a seed,
  the `--mlp-int4` guards and the flags that are not ported (`--mesh`, the HF
  snapshots).
"""

import dataclasses
import filecmp
import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vlm_bridge_tpu.configs import VLMConfig
from vlm_bridge_tpu.data import groundcap as jgc
from vlm_bridge_tpu.data import loader as jld
from vlm_bridge_tpu.data import pixel_cache as jpc
from vlm_bridge_tpu.data.tokenizer import ByteTokenizer as JByteTokenizer
from vlm_bridge_tpu.inference import evaluate as JE
from vlm_bridge_tpu.inference import generate as JG
from vlm_bridge_tpu.inference import metrics as jm
from vlm_bridge_tpu.models import bridge as jb
from vlm_bridge_tpu.models import full_model as jfm
from vlm_bridge_tpu.models import gemma2 as jg
from vlm_bridge_tpu_torch.data import groundcap as tgc
from vlm_bridge_tpu_torch.data import loader as tld
from vlm_bridge_tpu_torch.data import pixel_cache as tpc
from vlm_bridge_tpu_torch.data.tokenizer import ByteTokenizer
from vlm_bridge_tpu_torch.inference import evaluate as TE
from vlm_bridge_tpu_torch.inference import generate as TG
from vlm_bridge_tpu_torch.inference import metrics as tm
from vlm_bridge_tpu_torch.params.from_jax import config_from_jax as P
from vlm_bridge_tpu_torch.params.from_jax import from_jax


def _public(mod):
    return sorted(n for n in vars(mod) if not n.startswith("_"))


@pytest.mark.parametrize("jmod,tmod", [(jm, tm), (jgc, tgc), (jpc, tpc), (jld, tld)],
                         ids=["metrics", "groundcap", "pixel_cache", "loader"])
def test_copied_modules_have_the_jax_packages_names(jmod, tmod):
    assert _public(tmod) == _public(jmod)
    assert tmod.__name__.startswith("vlm_bridge_tpu_torch.")


METRIC_CASES = {
    "perfect": (["a dog runs fast", "the cat sleeps on the mat"],
                [["a dog runs fast"], ["the cat sleeps on the mat"]]),
    "partial": (["the the the cat", "a man walks a dog near the house", ""],
                [["the cat sat"], ["a man walks the dog near a red house", "man and dog"],
                 ["nothing here"]]),
    "no_overlap": (["x y z w"], [["a b c d"]]),
    "short": (["a b"], [["a b c d"]]),
}


@pytest.mark.parametrize("name", sorted(METRIC_CASES))
def test_metrics_equal_the_jax_package(name):
    cands, refs = METRIC_CASES[name]
    assert tm.evaluate_captions(cands, refs) == jm.evaluate_captions(cands, refs)
    assert tm.corpus_bleu(cands, refs) == jm.corpus_bleu(cands, refs)
    assert tm.cider_d(cands, refs) == jm.cider_d(cands, refs)


@pytest.fixture(scope="module")
def split_dirs(tmp_path_factory):
    """The same synthetic dataset written by both packages."""
    root = tmp_path_factory.mktemp("synth")
    counts = [m.make_synthetic_dataset(root / n, num_samples=50, image_size=70, seed=2)
              for m, n in ((jgc, "jax"), (tgc, "port"))]
    assert counts[0] == counts[1] == {"train": 40, "val": 1, "test": 9}
    return root / "jax", root / "port"


def test_synthetic_dataset_files_equal(split_dirs):
    jdir, pdir = split_dirs
    for split in ("train", "val", "test"):
        assert (pdir / split / "captions.jsonl").read_text() == \
            (jdir / split / "captions.jsonl").read_text()
        names = sorted(p.name for p in (jdir / split / "images").iterdir())
        assert names == sorted(p.name for p in (pdir / split / "images").iterdir())
        match, mismatch, errors = filecmp.cmpfiles(jdir / split / "images",
                                                   pdir / split / "images", names, shallow=False)
        assert (len(match), mismatch, errors) == (len(names), [], [])
    assert tgc.get_split_stats(pdir) == jgc.get_split_stats(jdir)
    raw = '<gdo id="3">a  man</gdo> walks <gda x="1">the dog</gda>\n now'
    assert tgc.clean_caption(raw) == jgc.clean_caption(raw) == "a man walks the dog now"
    assert tgc.split_bounds(41880) == jgc.split_bounds(41880)
    assert tgc.split_of_index(37000, tgc.split_bounds(41880)) == "test"


def _batches_equal(a, b):
    assert sorted(a) == sorted(b)
    assert a["captions"] == b["captions"]
    for k in ("pixel_values", "input_ids", "attn_mask"):
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("shuffle,drop_last,workers", [(False, False, 0), (True, True, 2)])
def test_loader_batches_equal(split_dirs, shuffle, drop_last, workers):
    jdir, _ = split_dirs     # one set of files, read by both packages
    jds, tds = jld.VLDataset(jdir, "train"), tld.VLDataset(jdir, "train")
    assert len(tds) == len(jds) == 40 and tds.samples == jds.samples and tds.pixels is None
    np.testing.assert_array_equal(tds.load_image(5), jds.load_image(5))
    kw = dict(batch_size=12, max_text_len=64, buckets=(32, 64), shuffle=shuffle, seed=4,
              num_workers=workers, drop_last=drop_last)
    jl = jld.BatchLoader(jds, tokenizer=JByteTokenizer(), **kw)
    tl = tld.BatchLoader(tds, tokenizer=ByteTokenizer(), **kw)
    assert len(tl) == len(jl) == (3 if drop_last else 4)
    for _ in range(2):       # two epochs: the shuffle advances with the epoch
        jbs, tbs = list(jl), list(tl)
        assert len(tbs) == len(jbs) == len(jl)
        for a, b in zip(tbs, jbs):
            _batches_equal(a, b)
    _batches_equal(tl.first_batch(), jl.first_batch())


def test_pixel_cache_is_shared_between_the_packages(split_dirs, capsys):
    jdir, pdir = split_dirs
    tds, jds = tld.VLDataset(pdir, "test"), jld.VLDataset(pdir, "test")
    assert tpc.manifest_fingerprint(tds.root, tds.samples) == \
        jpc.manifest_fingerprint(jds.root, jds.samples)
    assert tpc.try_attach(tds.root, tds.samples) is None
    path = tpc.build_pixel_cache(tds, num_workers=2, verbose=False)   # built by the port
    assert path.name == tpc.CACHE_NAME == jpc.CACHE_NAME and tpc.META_NAME == jpc.META_NAME
    for ds in (tld.VLDataset(pdir, "test"), jld.VLDataset(pdir, "test")):   # attached by both
        assert ds.pixels is not None and ds.pixels.shape == (9, 224, 224, 3)
        np.testing.assert_array_equal(ds.load_image(7), ds.decode_image(7))
    cached = next(iter(tld.BatchLoader(tld.VLDataset(pdir, "test"), batch_size=4,
                                       tokenizer=ByteTokenizer(), num_workers=0)))
    plain = next(iter(tld.BatchLoader(tld.VLDataset(pdir, "test", pixel_cache="off"),
                                      batch_size=4, tokenizer=ByteTokenizer(), num_workers=0)))
    _batches_equal(cached, plain)
    # a manifest that no longer matches the cache is refused
    assert tpc.try_attach(tds.root, tds.samples[:-1]) is None
    train, val, test = tld.get_data_loaders(pdir, batch_size=4, tokenizer=ByteTokenizer(),
                                            num_workers=0)
    assert (len(train), len(val), len(test)) == (10, 1, 3)
    tld.inspect_data_loader(val, num_batches=1)
    assert "batch 0: pixels (1, 224, 224, 3) uint8" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError, match="missing manifest"):
        tld.VLDataset(pdir, "nope")


# ---------------------------------------------------------------------------
# evaluate_split against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    base = VLMConfig.tiny_test()
    cfg = dataclasses.replace(base, lm=dataclasses.replace(base.lm, sliding_window=128))
    params = jax.jit(lambda k: jfm.init(k, cfg, frozen_dtype=jnp.float32))(jax.random.key(0))
    quant = jax.jit(lambda p: {**p, "lm": jg.quantize_params(p["lm"]),
                               "bridge": jb.quantize_decode_params(p["bridge"])})(params)
    to_np = lambda t: jax.tree.map(np.array, t)  # noqa: E731
    return cfg, {"float": (params, from_jax(to_np(params))),
                 "int8": (quant, from_jax(to_np(quant)))}


EVAL_CASES = {
    # float weights, per-layer path; 9 test samples in batches of 4: a padded last batch
    "float_padded_last_batch": ("float", dict(), dict(batch_size=4)),
    # the int8 recipe on the fused path (the JAX package on its jnp path: the same ids)
    "int8_fused": ("int8", dict(kv_quant=True), dict(batch_size=4)),
    "int8_fused_max_samples": ("int8", dict(kv_quant=True), dict(batch_size=4, max_samples=6)),
}


@pytest.mark.parametrize("name", sorted(EVAL_CASES))
def test_evaluate_split_matches_jax(split_dirs, models, name):
    which, gen_kw, kw = EVAL_CASES[name]
    cfg, trees = models
    pj, pt = trees[which]
    jdir, _ = split_dirs
    common = dict(split="test", verbose=False, **kw)
    want = JE.evaluate_split(
        pj, cfg, jdir, tokenizer=JByteTokenizer(), activation_dtype=jnp.float32,
        gen=JG.GenerationConfig(max_length=6, greedy=True, force_jnp=True, **gen_kw), **common)
    got = TE.evaluate_split(
        pt, P(cfg), jdir, tokenizer=ByteTokenizer(), activation_dtype=torch.float32,
        gen=TG.GenerationConfig(max_length=6, greedy=True, **gen_kw), **common)
    n = kw.get("max_samples", 9)
    assert got["num_samples"] == want["num_samples"] == n
    assert got["samples"] == [tuple(s) for s in want["samples"]] and len(got["samples"]) == min(n, 10)
    assert sorted(got["metrics"]) == sorted(want["metrics"])
    for k, v in want["metrics"].items():
        assert got["metrics"][k] == pytest.approx(v, abs=1e-6), k
    assert got["captions_per_sec"] > 0 and got["device"] == "cpu" and not got["pixel_cache"]
    assert got["captions_per_sec_timing"] == want["captions_per_sec_timing"]


def test_evaluate_split_int4_recipe_and_dump(split_dirs, models, tmp_path):
    """The int4 recipe through the harness on the CPU (plain versions): the
    captions are those of generate_tokens on the same batches, in dataset
    order, and every pair is dumped."""
    cfg, trees = models
    pj, _ = trees["float"]
    q4 = {**pj, "lm": jg.quantize_params(pj["lm"], ("embedding4", "mlp", "attn")),
          "bridge": jb.quantize_decode_params(pj["bridge"])}
    pt = from_jax(jax.tree.map(np.array, q4))
    gen = TG.GenerationConfig(max_length=5, greedy=True, kv_quant=True, mlp_int4=True,
                              mlp_int4_group=16)
    jdir, _ = split_dirs
    dump = tmp_path / "pairs.jsonl"
    got = TE.evaluate_split(pt, P(cfg), jdir, tokenizer=ByteTokenizer(), split="test",
                            batch_size=6, gen=gen, activation_dtype=torch.float32,
                            verbose=False, dump_samples=dump)
    ds = tld.VLDataset(jdir, "test")
    pairs = [json.loads(s) for s in dump.read_text().splitlines()]
    assert got["num_samples"] == len(pairs) == 9
    assert [p["reference"] for p in pairs] == [ds.caption(i) for i in range(9)]
    from vlm_bridge_tpu_torch.data.preprocess import normalize_on_device
    from vlm_bridge_tpu_torch.inference.robust import decode_captions

    pix = np.stack([ds.load_image(i) for i in range(6)])
    toks, lens = TG.generate_tokens(pt, P(cfg), gen=gen, activation_dtype=torch.float32,
                                    pixel_values=normalize_on_device(torch.from_numpy(pix),
                                                                     dtype=torch.float32))
    assert [p["generated"] for p in pairs[:6]] == decode_captions(ByteTokenizer(), toks.numpy(),
                                                                  lens.numpy())
    assert all(np.isfinite(v) for v in got["metrics"].values())


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _cli(data, *extra):
    return ["--data-dir", str(data), "--split", "test", "--preset", "tiny_wide", "--device",
            "cpu", "--batch-size", "4", "--max-length", "5", "--max-samples", "6", *extra]


def test_vlm_eval_torch_cli_int4_head_and_sampling(split_dirs, tmp_path, capsys):
    jdir, _ = split_dirs
    out = tmp_path / "r.json"
    rc = TE.main(_cli(jdir, "--quantize", "embedding4,mlp,attn,bridge", "--kv-int8",
                      "--no-early-stop", "--output", str(out)))
    assert rc == 0
    res = json.loads(out.read_text())
    assert res["num_samples"] == 6 and "bleu4" in res["metrics"] and "samples" not in res
    assert "captions/s on cpu" in capsys.readouterr().out
    dumps = []
    for i in range(2):       # --seed seeds the weights and the sampling stream: same captions
        d = tmp_path / f"s{i}.jsonl"
        assert TE.main(_cli(jdir, "--quantize", "embedding4,mlp,attn,bridge", "--kv-int8",
                            "--sample", "--temperature", "1.5", "--top-p", "0.95", "--seed", "5",
                            "--dump-samples", str(d))) == 0
        dumps.append(d.read_text())
    assert len(dumps[0].splitlines()) == 6
    assert dumps[0] == dumps[1]


def test_vlm_eval_torch_mlp_int4_guards(split_dirs, tmp_path):
    """--mlp-int4 fails loudly where the fused stack cannot serve: nothing
    measures int8 MLP weights under the int4 label."""
    jdir, _ = split_dirs
    with pytest.raises(SystemExit, match="kv-int8"):
        TE.main(_cli(jdir, "--mlp-int4"))
    with pytest.raises(SystemExit, match="fully int8"):
        TE.main(_cli(jdir, "--mlp-int4", "--kv-int8", "--quantize", "embedding4,bridge"))
    # the CLI's scale group is the default 128, as in the JAX package: widths that
    # hold no whole group are refused by the stacker, not served per channel
    with pytest.raises(ValueError, match="mlp_int4_group"):
        TE.main(_cli(jdir, "--mlp-int4", "--kv-int8", "--quantize",
                     "embedding4,mlp,attn,bridge"))
    # --mesh D needs a process group of D processes; a model axis is not ported
    with pytest.raises(ValueError, match="mesh 2x1 != 1 processes"):
        TE.main(_cli(jdir, "--mesh", "2"))
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        TE.main(_cli(jdir, "--mesh", "1,2"))
    with pytest.raises(SystemExit, match="not --exact"):
        TE.main(_cli(jdir, "--mlp-int4", "--kv-int8", "--exact"))
    # --checkpoint reads a CheckpointStore slot (tests/test_torch_training_loop.py
    # serves a trained one); --hf-*-path reads a snapshot directory
    # (tests/test_torch_hf_loader.py loads real ones)
    with pytest.raises(FileNotFoundError, match="no checkpoint slot"):
        TE.main(_cli(jdir, "--checkpoint", str(tmp_path / "store" / "best")))
    with pytest.raises(FileNotFoundError, match="no .safetensors files"):
        TE.main(_cli(jdir, "--hf-vision-path", str(tmp_path / "x")))
    with pytest.raises(ValueError, match="mutually exclusive"):
        TE.main(_cli(jdir, "--quantize", "embedding,embedding4"))


def test_vlm_caption_torch_serves_the_int4_table(tmp_path):
    """`vlm-caption-torch --quantize embedding4,...` raised before the int4
    table was ported; it serves now, through the int4 head."""
    from PIL import Image

    from vlm_bridge_tpu_torch.inference import caption

    rng = np.random.default_rng(1)
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (60, 80, 3), dtype=np.uint8)).save(
            tmp_path / f"img{i}.png")
    out = tmp_path / "caps.jsonl"
    assert caption.main([str(tmp_path), "--preset", "tiny_wide", "--device", "cpu", "--quantize",
                         "embedding4,mlp,attn,bridge", "--max-length", "4", "--output",
                         str(out)]) == 0
    assert len(out.read_text().splitlines()) == 2
