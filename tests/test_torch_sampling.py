"""PyTorch port, ops.sampling against vlm_bridge_tpu.ops.sampling.

What is deterministic (the guards, greedy ids, the dropped tail mass) must
equal the JAX functions on the same logits. A random draw cannot: the two
packages' streams differ. There the bar is the set a draw may come from:
every token the port samples lies inside the nucleus that JAX's top_k /
softmax / cumsum keep for those logits, the top-1 token is always kept, and
one seed gives one sequence.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vlm_bridge_tpu.ops import sampling as js
from vlm_bridge_tpu_torch.ops import sampling as ts

B, V = 6, 400


@pytest.fixture(scope="module")
def logits():
    rng = np.random.default_rng(5)
    x = rng.normal(0, 3, (B, V)).astype(np.float32)
    x[1] *= 4.0            # a peaked row: the nucleus is one or two tokens
    x[2] *= 0.05           # a flat row: the nucleus outgrows a small window
    return x


def _guard_cases():
    rng = np.random.default_rng(6)
    x = rng.normal(0, 50, (5, 33)).astype(np.float32)
    x[0, 3] = np.nan                       # NaN row -> zeros
    x[1, 4], x[1, 9] = np.inf, -np.inf     # Inf row -> clamped to +/-100
    x[2, 0], x[2, 1] = np.nan, np.inf      # both: the NaN rule wins
    x[3, 7] = 250.0                        # finite rows pass through unclamped
    return x


def test_sanitize_logits_equals_jax():
    x = _guard_cases()
    want = np.asarray(js.sanitize_logits(jnp.asarray(x)))
    got = ts.sanitize_logits(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[0] == 0).all() and got[1].max() == 100.0 and got[1].min() == -100.0
    assert got[3, 7] == 250.0


@pytest.mark.parametrize("kw", [dict(greedy=True), dict(temperature=0.0),
                                dict(greedy=True, temperature=0.3, top_p=0.5)],
                         ids=["greedy", "temperature0", "greedy_wins"])
def test_greedy_ids_equal_jax(logits, kw):
    for x in (logits, _guard_cases()):
        want = np.asarray(js.sample_token(jax.random.key(0), jnp.asarray(x), **kw))
        got = ts.sample_token(None, torch.from_numpy(x), **kw)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("window", [8, 128])
@pytest.mark.parametrize("temperature,top_p", [(0.7, 0.9), (1.0, 0.5)])
def test_topp_window_tail_mass_equals_jax(logits, window, temperature, top_p):
    kw = dict(temperature=temperature, top_p=top_p, topk_window=window)
    want = np.asarray(js.topp_window_tail_mass(jnp.asarray(logits), **kw))
    got = ts.topp_window_tail_mass(torch.from_numpy(logits), **kw).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)   # f32 exp / logsumexp
    if window == 8 and top_p == 0.9:
        assert got[2] > 0.5 and got[1] == 0.0   # the flat row loses its tail, the peaked none


def _jax_kept(x: np.ndarray, temperature: float, top_p: float, k: int):
    """Per row, the set of token ids JAX's nucleus keeps."""
    scaled = js.sanitize_logits(jnp.asarray(x, jnp.float32)) / temperature
    vals, idx = jax.lax.top_k(scaled, k)
    cum = jnp.cumsum(jax.nn.softmax(vals, axis=-1), axis=-1)
    keep = np.concatenate([np.ones((x.shape[0], 1), bool), np.asarray(cum[:, :-1] < top_p)], 1)
    idx = np.asarray(idx)
    return [set(idx[b][keep[b]].tolist()) for b in range(x.shape[0])], idx[:, 0]


@pytest.mark.parametrize("exact_topp", [False, True], ids=["windowed", "exact"])
@pytest.mark.parametrize("temperature,top_p,window", [(0.7, 0.9, 128), (1.0, 0.6, 16),
                                                      (0.3, 0.95, 128), (1.5, 0.85, 5)])
def test_every_sample_lies_in_the_set_jax_keeps(logits, temperature, top_p, window, exact_topp):
    k = V if exact_topp else window
    kept, top1 = _jax_kept(logits, temperature, top_p, k)
    assert all(int(top1[b]) in kept[b] for b in range(B))      # top-1 always kept
    g = torch.Generator().manual_seed(7)
    seen = [set() for _ in range(B)]
    for _ in range(60):
        ids = ts.sample_token(g, torch.from_numpy(logits), temperature=temperature,
                              top_p=top_p, topk_window=window, exact_topp=exact_topp)
        assert ids.dtype == torch.int32 and tuple(ids.shape) == (B,)
        for b, i in enumerate(ids.tolist()):
            assert i in kept[b], (b, i)
            seen[b].add(i)
    # the draws do spread over a nucleus of several tokens
    assert any(len(s) > 1 for s in seen)
    assert all(len(seen[b]) == 1 for b in range(B) if len(kept[b]) == 1)


def test_nucleus_of_one_token_is_the_argmax():
    x = np.zeros((3, 50), np.float32)
    x[0, 7], x[1, 0], x[2, 49] = 30.0, 30.0, 30.0
    g = torch.Generator().manual_seed(1)
    for _ in range(5):
        ids = ts.sample_token(g, torch.from_numpy(x), temperature=0.7, top_p=0.9)
        assert ids.tolist() == [7, 0, 49]


@pytest.mark.parametrize("top_p", [None, 1.0])
def test_plain_categorical_follows_the_softmax(top_p):
    """top_p None or >= 1: no filter. 4000 draws of a three-token
    distribution land within 0.03 of softmax(logits / temperature)."""
    x = np.full((1, 6), -1e4, np.float32)
    x[0, :3] = [0.0, 0.7, 1.4]
    want = np.asarray(jax.nn.softmax(jnp.asarray(x[0, :3]) / 0.7))
    g = torch.Generator().manual_seed(2)
    big = torch.from_numpy(np.repeat(x, 4000, axis=0))
    ids = ts.sample_token(g, big, temperature=0.7, top_p=top_p).numpy()
    assert ids.max() <= 2
    freq = np.bincount(ids, minlength=3) / ids.size
    np.testing.assert_allclose(freq, want, atol=0.03)


def test_same_seed_same_tokens_and_the_stream_advances(logits):
    x = torch.from_numpy(logits)

    def run(seed, n=4):
        g = torch.Generator().manual_seed(seed)
        return torch.stack([ts.sample_token(g, x, temperature=1.0, top_p=0.95)
                            for _ in range(n)])

    a, b, c = run(3), run(3), run(4)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert not all(torch.equal(a[0], a[i]) for i in range(1, 4))   # one generator, advanced


def test_nan_and_inf_rows_still_sample_valid_ids():
    x = _guard_cases()
    g = torch.Generator().manual_seed(9)
    ids = ts.sample_token(g, torch.from_numpy(x), temperature=0.7, top_p=0.9, topk_window=8)
    assert ((ids >= 0) & (ids < x.shape[1])).all()
    kept, _ = _jax_kept(x, 0.7, 0.9, 8)
    # the clamped Inf row and the finite rows; the all-zero rows 0 and 2 are one
    # big tie, where top_k's order is each library's own
    assert all(int(ids[b]) in kept[b] for b in (1, 3, 4))
