"""PyTorch port, the checkpoint border on the CPU:

- `.pth` interop with the JAX package both ways: a file the JAX `save_pth`
  writes (the reference's FullModel.save_model layout), a trainer-layout file
  and a bare state dict, read by the port's `load_pth`, give the JAX
  `bridge.forward`'s output (f32, 1e-5); the port's `save_pth` is read by the
  JAX `load_pth` the same way, and its state dict equals the JAX one key for
  key and bit for bit;
- `CheckpointStore`: a full slot round trip (bridge and optimizer state bit
  for bit, meta.json), a weights-only restore from a full slot, the
  refusal of a leaf whose shape or dtype differs, and the `.tmp` swap (a
  failed write leaves the old slot whole);
- `BridgeOptimizer.state_dict` / `load_state_dict`: restored moments, step,
  schedule count and accumulation continue bit for bit, with k = 1 and 2;
- `vlm-convert-torch`: pth-to-slot, slot-to-pth and show.
"""

import json

import numpy as np
import pytest
import jax
import torch

from vlm_bridge_tpu.configs import BridgeConfig as JBridgeConfig
from vlm_bridge_tpu.models import bridge as jb
from vlm_bridge_tpu.params import torch_bridge as jtb
from vlm_bridge_tpu_torch.configs import TrainingConfig
from vlm_bridge_tpu_torch.models import bridge as tb
from vlm_bridge_tpu_torch.params import torch_bridge as ttb
from vlm_bridge_tpu_torch.params.from_jax import config_from_jax as P
from vlm_bridge_tpu_torch.params.from_jax import from_jax
from vlm_bridge_tpu_torch.runtime.checkpoint import CheckpointStore
from vlm_bridge_tpu_torch.training import train_step as ts


@pytest.fixture(scope="module")
def bridge_case():
    cfg = JBridgeConfig.tiny_test()
    params = jax.tree.map(np.asarray, jb.init(jax.random.key(2), cfg))
    rng = np.random.default_rng(0)
    # Xavier weights with zero biases and unit LayerNorms would hide a bias or
    # scale that lands in the wrong slot: perturb every leaf
    params = jax.tree.map(lambda a: (a + rng.normal(0, 0.05, a.shape)).astype(np.float32), params)
    text = rng.normal(0, 1, (2, 5, cfg.language_dim)).astype(np.float32)
    vision = rng.normal(0, 1, (2, 4, cfg.vision_dim)).astype(np.float32)
    want = np.asarray(jb.forward(params, cfg, text, vision))
    return cfg, params, text, vision, want


def _port_forward(cfg, tparams, text, vision):
    return tb.forward(tparams, P(cfg), torch.from_numpy(text), torch.from_numpy(vision)).numpy()


@pytest.mark.parametrize("layout", ["save_model", "trainer", "bare"])
def test_pth_written_by_jax_reads_in_the_port(bridge_case, tmp_path, layout):
    cfg, params, text, vision, want = bridge_case
    path = tmp_path / "bridge.pth"
    if layout == "save_model":
        jtb.save_pth(params, cfg, path)
    else:
        sd = {k: torch.from_numpy(np.array(v)) for k, v in
              jtb.bridge_to_state_dict(params, cfg).items()}
        if layout == "trainer":
            sd = {"model_state_dict": {f"bridge_module.{k}": v for k, v in sd.items()},
                  "optimizer_state_dict": {"state": {}}, "epoch": 3}
        torch.save(sd, path)
    tparams = ttb.load_pth(path, P(cfg))
    assert tparams["blocks"]["0"]["ffn"]["fc1"].shape == (cfg.language_dim,
                                                          cfg.language_dim * cfg.ffn_mult)
    np.testing.assert_allclose(_port_forward(cfg, tparams, text, vision), want,
                               rtol=1e-5, atol=1e-5)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(b.numpy(), a), params, tparams)


def test_pth_written_by_the_port_reads_in_jax(bridge_case, tmp_path):
    cfg, params, text, vision, want = bridge_case
    tparams = from_jax(params)
    path = tmp_path / "port.pth"
    ttb.save_pth(tparams, P(cfg), path)
    raw = torch.load(path, weights_only=True)
    assert set(raw) == {"bridge_module_state_dict", "model_config"}
    jsd = jtb.bridge_to_state_dict(params, cfg)
    tsd = raw["bridge_module_state_dict"]
    assert sorted(tsd) == sorted(jsd)
    for k, v in jsd.items():
        np.testing.assert_array_equal(tsd[k].numpy(), v)
        assert tsd[k].dtype == torch.float32 and tsd[k].is_contiguous()
    back = jtb.load_pth(path, cfg)
    np.testing.assert_allclose(np.asarray(jb.forward(back, cfg, text, vision)), want,
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="bridge_blocks"):
        ttb.extract_bridge_state_dict({"something": torch.zeros(1)})


def _trained_optimizer(k: int, steps: int = 3):
    """A tiny bridge after `steps` BridgeOptimizer updates from seeded
    gradients, and the gradients of the next two steps."""
    cfg = P(JBridgeConfig.tiny_test())
    tc = TrainingConfig(gradient_accumulation_steps=k, learning_rate=1e-2, min_lr=1e-3,
                        num_epochs=1)
    g = torch.Generator().manual_seed(k)
    params = {"bridge": tb.init(cfg, generator=g)}
    state, opt = ts.init_train_state(params, tc, steps_per_epoch=10)
    leaves = ts.tree_leaves(state.bridge_params)
    grads = [[torch.randn(p.shape, generator=g) for p in leaves] for _ in range(steps + 2)]
    for gr in grads[:steps]:
        opt.update(gr, state.opt_state, leaves)
    return cfg, tc, state, opt, grads[steps:]


@pytest.mark.parametrize("k", [1, 2])
def test_store_round_trip_and_optimizer_state_continue_bit_for_bit(tmp_path, k):
    cfg, tc, state, opt, more = _trained_optimizer(k)
    store = CheckpointStore(tmp_path / "ckpt")
    meta = {"epoch": 0, "step": 3, "bridge_causal": True}
    saved_opt = opt.state_dict(state.opt_state, state.bridge_params)
    store.save("latest", bridge_params=state.bridge_params, opt_state=saved_opt, meta=meta)
    assert sorted(p.name for p in (tmp_path / "ckpt" / "latest").iterdir()) == [
        "bridge_params.pt", "meta.json", "opt_state.pt"]
    assert not (tmp_path / "ckpt" / "latest.tmp").exists() and store.exists("latest")

    # a fresh state (zero moments) as the template, then restored in place
    fresh, opt2 = ts.init_train_state({"bridge": tb.init(cfg, generator=torch.Generator())}, tc,
                                      steps_per_epoch=10)
    template = {"bridge_params": fresh.bridge_params,
                "opt_state": opt2.state_dict(fresh.opt_state, fresh.bridge_params)}
    restored, got_meta = store.load("latest", template=template)
    assert got_meta == meta
    with torch.no_grad():
        for p, r in zip(ts.tree_leaves(fresh.bridge_params),
                        ts.tree_leaves(restored["bridge_params"])):
            p.copy_(r)
    opt2.load_state_dict(fresh.opt_state, restored["opt_state"], fresh.bridge_params)
    again = opt2.state_dict(fresh.opt_state, fresh.bridge_params)
    for a, b in zip(ts.tree_leaves(again), ts.tree_leaves(saved_opt)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # both go on with the same gradients: the same bits
    leaves_a, leaves_b = ts.tree_leaves(state.bridge_params), ts.tree_leaves(fresh.bridge_params)
    for gr in more:
        opt.update(gr, state.opt_state, leaves_a)
        opt2.update([x.clone() for x in gr], fresh.opt_state, leaves_b)
    assert all(torch.equal(a, b) for a, b in zip(leaves_a, leaves_b))
    assert state.opt_state["count"] == fresh.opt_state["count"] == (5 if k == 1 else 2)


def test_store_partial_restore_and_leaf_mismatch(tmp_path):
    cfg, tc, state, opt, _ = _trained_optimizer(1)
    store = CheckpointStore(tmp_path)
    store.save("best", bridge_params=state.bridge_params,
               opt_state=opt.state_dict(state.opt_state, state.bridge_params))
    store.save("best_weights_only", bridge_params=state.bridge_params)
    for slot in ("best", "best_weights_only"):      # weights only, from either slot
        restored, meta = store.load(slot, template={"bridge_params": state.bridge_params})
        assert set(restored) == {"bridge_params"} and meta == {}
        for a, b in zip(ts.tree_leaves(restored["bridge_params"]),
                        ts.tree_leaves(state.bridge_params)):
            assert torch.equal(a, b.detach())
    with pytest.raises(ValueError, match="opt_state"):
        store.load("best_weights_only", template={
            "bridge_params": state.bridge_params,
            "opt_state": opt.state_dict(state.opt_state, state.bridge_params)})
    wrong = ts.tree_map(lambda p: p.detach().clone(), state.bridge_params)
    wrong["blocks"]["1"]["ffn"]["fc2"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="leaf mismatch"):
        store.load("best", template={"bridge_params": wrong})
    wrong["blocks"]["1"]["ffn"]["fc2"] = state.bridge_params["blocks"]["1"]["ffn"]["fc2"].double()
    with pytest.raises(ValueError, match="leaf mismatch"):
        store.load("best", template={"bridge_params": wrong})
    with pytest.raises(FileNotFoundError):
        store.load("latest", template={"bridge_params": state.bridge_params})
    everything, _ = store.load("best", template=None)
    assert set(everything) == {"bridge_params", "opt_state"}


def test_store_tmp_swap_keeps_the_old_slot_on_a_failed_write(tmp_path, monkeypatch):
    store = CheckpointStore(tmp_path)
    old = {"w": torch.ones(3)}
    store.save("latest", bridge_params=old, meta={"epoch": 0})
    real = torch.save

    def failing(obj, f, *a, **kw):
        if str(f).endswith("opt_state.pt"):
            raise OSError("disk full")
        return real(obj, f, *a, **kw)

    monkeypatch.setattr(torch, "save", failing)
    with pytest.raises(OSError):
        store.save("latest", bridge_params={"w": torch.zeros(3)},
                   opt_state={"count": torch.tensor(1)}, meta={"epoch": 1})
    monkeypatch.setattr(torch, "save", real)
    assert (tmp_path / "latest.tmp").exists()
    restored, meta = store.load("latest", template={"bridge_params": old})
    assert torch.equal(restored["bridge_params"]["w"], old["w"]) and meta == {"epoch": 0}
    store.save("latest", bridge_params={"w": torch.zeros(3)}, meta={"epoch": 2})
    assert not (tmp_path / "latest.tmp").exists()
    assert store.load("latest", template={"bridge_params": old})[1] == {"epoch": 2}


def test_vlm_convert_torch_round_trip(bridge_case, tmp_path, capsys):
    from vlm_bridge_tpu_torch.tools import convert

    cfg, params, text, vision, want = bridge_case
    src = tmp_path / "ref.pth"
    jtb.save_pth(params, cfg, src)
    assert convert.main(["show", str(src)]) == 0
    out = capsys.readouterr().out
    assert "layout: FullModel.save_model" in out and "sidecar keys: ['model_config']" in out
    assert convert.main(["pth-to-slot", str(src), str(tmp_path / "store"), "--preset",
                         "tiny"]) == 0
    assert f"imported {jb.num_params(params):,} params" in capsys.readouterr().out
    meta = json.loads((tmp_path / "store" / "imported" / "meta.json").read_text())
    assert meta["source"] == str(src.resolve())
    back = tmp_path / "back.pth"
    assert convert.main(["slot-to-pth", str(tmp_path / "store"), str(back), "--slot",
                         "imported", "--preset", "tiny"]) == 0
    a = torch.load(src, weights_only=True)["bridge_module_state_dict"]
    b = torch.load(back, weights_only=True)["bridge_module_state_dict"]
    assert sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)
    np.testing.assert_allclose(_port_forward(cfg, ttb.load_pth(back, P(cfg)), text, vision),
                               want, rtol=1e-5, atol=1e-5)
    # a preset whose widths differ from the slot's is refused
    with pytest.raises(ValueError, match="leaf mismatch"):
        convert.main(["slot-to-pth", str(tmp_path / "store"), str(back), "--slot", "imported",
                      "--preset", "tiny_ref"])
