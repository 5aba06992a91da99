"""PyTorch port, the four int8 linear functions of ops.quant: each plain
version (what the CPU runs and what the CUDA kernel is held to on the card)
against the JAX function, both as its Pallas kernel in interpret mode and as
its jnp fallback, at shapes with M not a multiple of 8 and I, O, F not
multiples of 128.

Tolerances. f32 inputs against the jnp fallback: the same f32 algebra in
another summation order, F32_TOL x max|ref|. bf16 inputs (the dtype of the
card; the Pallas bodies round x and the hidden to bf16 whatever they get):
both sides round the result to bf16, and a hidden value on a rounding tie
may differ by one step, so BF16_TOL = one bf16 step (2^-7) of max|ref|.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from vlm_bridge_tpu.ops import layers as jl
from vlm_bridge_tpu.ops import quant as jq
from vlm_bridge_tpu_torch.ops import layers as tl
from vlm_bridge_tpu_torch.ops import quant as tq
from vlm_bridge_tpu_torch.params.from_jax import from_jax

F32_TOL, BF16_TOL = 2e-6, 2.0 ** -7
M, H, F, V = 5, 72, 200, 500   # rows, hidden, FFN width, vocabulary

JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _quantized(rng, shape, axis):
    w = rng.normal(0, 0.05, shape).astype(np.float32)
    q = jq.quantize_int8(jnp.asarray(w), axis=axis)
    return {k: np.asarray(v) for k, v in q.items()}


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(11)
    return {
        "x": rng.normal(0, 1, (M, H)).astype(np.float32),
        "w": _quantized(rng, (H, F), 0),        # int8_matmul
        "gate": _quantized(rng, (H, F), 0), "up": _quantized(rng, (H, F), 0),
        "down": _quantized(rng, (F, H), 0),     # int8_mlp
        "b1": rng.normal(0, 0.1, F).astype(np.float32),
        "b2": rng.normal(0, 0.1, H).astype(np.float32),   # int8_ffn reuses gate / down
        "table": _quantized(rng, (V, H), 1),    # int8_matmul_t
    }


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _calls(c, dt):
    """name -> (JAX call, port wrapper call, port plain call) on the same arrays."""
    xj, xt = jnp.asarray(c["x"], JDT[dt]), torch.from_numpy(c["x"]).to(TDT[dt])
    t = {k: from_jax(v) for k, v in c.items() if k != "x"}
    return {
        "int8_matmul": (lambda: jq.int8_matmul(xj, _j(c["w"])),
                        lambda: tq.int8_matmul(xt, t["w"]),
                        lambda: tq.int8_matmul_plain(xt, t["w"])),
        "int8_mlp": (lambda: jq.int8_mlp(xj, _j(c["gate"]), _j(c["up"]), _j(c["down"])),
                     lambda: tq.int8_mlp(xt, t["gate"], t["up"], t["down"]),
                     lambda: tq.int8_mlp_plain(xt, t["gate"], t["up"], t["down"])),
        "int8_ffn": (lambda: jq.int8_ffn(xj, _j(c["gate"]), jnp.asarray(c["b1"]),
                                         _j(c["down"]), jnp.asarray(c["b2"])),
                     lambda: tq.int8_ffn(xt, t["gate"], t["b1"], t["down"], t["b2"]),
                     lambda: tq.int8_ffn_plain(xt, t["gate"], t["b1"], t["down"], t["b2"])),
        "int8_matmul_t": (lambda: jq.int8_matmul_t(xj, _j(c["table"])),
                          lambda: tq.int8_matmul_t(xt, t["table"]),
                          lambda: tq.int8_matmul_t_plain(xt, t["table"])),
    }


NAMES = ("int8_matmul", "int8_mlp", "int8_ffn", "int8_matmul_t")


def _err(got: torch.Tensor, want) -> float:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.abs(got.float().numpy() - want).max() / np.abs(want).max())


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("name", NAMES)
def test_plain_matches_jnp_fallback(case, name, dt):
    jax_fn, wrapper, plain = _calls(case, dt)[name]
    want = jax_fn()
    got = plain()
    assert got.dtype == (torch.float32 if name == "int8_matmul_t" else TDT[dt])
    assert tuple(got.shape) == tuple(want.shape)
    assert _err(got, want) <= (F32_TOL if dt == "f32" else BF16_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_plain_matches_pallas_kernel_in_interpret_mode(case, name, monkeypatch):
    """bf16 x on both sides: the Pallas bodies round x, the hidden and the
    weights' widening exactly as the plain versions do for a bf16 input."""
    monkeypatch.setattr(jq, "INTERPRET", True)
    jax_fn, wrapper, plain = _calls(case, "bf16")[name]
    want = jax_fn()
    assert _err(plain(), want) <= BF16_TOL
    # the f32 logits of the head carry no output rounding: far tighter
    if name == "int8_matmul_t":
        assert _err(plain(), want) <= 1e-5


@pytest.mark.parametrize("name", NAMES)
def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing(case, name, monkeypatch):
    from vlm_bridge_tpu_torch.ops import cuda_lib

    monkeypatch.setattr(cuda_lib, "lib", lambda: pytest.fail("a CPU tensor built the kernels"))
    fn = getattr(tq, name)
    before = fn.launches
    for dt in ("f32", "bf16"):
        _, wrapper, plain = _calls(case, dt)[name]
        assert torch.equal(wrapper(), plain())
    assert fn.launches == before


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_linear_on_an_int8_dict(case, dt, bias):
    """ops.layers.linear flattens [B, T, I] to rows, goes through
    int8_matmul and adds the bias afterwards in y's dtype, as the JAX
    function does."""
    rng = np.random.default_rng(12)
    x = rng.normal(0, 1, (2, 3, H)).astype(np.float32)
    b = rng.normal(0, 0.1, F).astype(np.float32) if bias else None
    want = jl.linear(jnp.asarray(x, JDT[dt]), _j(case["w"]),
                     None if b is None else jnp.asarray(b))
    before = tq.int8_matmul.launches
    got = tl.linear(torch.from_numpy(x).to(TDT[dt]), from_jax(case["w"]),
                    None if b is None else torch.from_numpy(b))
    assert tq.int8_matmul.launches == before
    assert got.dtype == TDT[dt] and tuple(got.shape) == (2, 3, F)
    assert _err(got, want) <= (F32_TOL if dt == "f32" else BF16_TOL)
    # a non-contiguous view goes through as well
    xt = torch.from_numpy(x).to(TDT[dt])
    assert torch.equal(tl.linear(xt.transpose(0, 1), from_jax(case["w"])),
                       tl.linear(xt.transpose(0, 1).contiguous(), from_jax(case["w"])))


def _slices(K: int, split: int) -> list:
    """The int8 product kernel's slices of the contraction (csrc/int8_linear.cu,
    unit_of): slice s takes the 64-row stages [s chunks // split, (s + 1)
    chunks // split), as (first row, end row) pairs."""
    chunks = -(-K // tq._I8_TILE_K)
    return [(s * chunks // split * tq._I8_TILE_K,
             min(K, (s + 1) * chunks // split * tq._I8_TILE_K)) for s in range(split)]


SPLIT_CASES = [
    ((64, 4096, 2304), False),    # Gemma-2-2B fused qkv
    ((64, 2304, 2048), False),    # its o projection
    ((64, 6912, 2304), False),    # bridge self qkv
    ((64, 9216, 2304), True),     # gate | up
    ((64, 2304, 9216), False),    # down
    ((64, 8192, 4608), False),    # Gemma-2-27B fused qkv
    ((64, 4608, 36864), False),   # its down: a deep contraction
    ((130, 2320, 2312), False),   # past the decode form's rows: the tower's form
    ((16448, 3072, 1024), False),  # the int8 tower's qkv
    ((1, 16, 8), False),          # one stage
    ((3, 2320, 2312), True),      # ragged K and N, GeGLU tiles
]


@pytest.mark.parametrize("shape,dual", SPLIT_CASES, ids=[f"{m}x{n}x{k}{'_dual' * d}"
                                                        for (m, n, k), d in SPLIT_CASES])
def test_contraction_split_plan(shape, dual):
    """The int8 product kernel's plan: at most one cluster's 8 slices, none
    empty, the slices covering K in order; the tower's rows are not split;
    a decode shape of few column tiles is; a pure function of its arguments."""
    m, n, k = shape
    s = tq.contraction_split(m, n, k, dual=dual, sms=132)
    assert 1 <= s <= tq._I8_MAX_SPLIT
    slices = _slices(k, s)
    assert len(slices) == s and slices[0][0] == 0 and slices[-1][1] == k
    assert all(a < b for a, b in slices)                                  # none is empty
    assert all(slices[i][1] == slices[i + 1][0] for i in range(s - 1))    # in order, no gap
    if m > tq._I8_DECODE_ROWS:
        assert s == 1
    if (m, n) == (64, 2304):
        assert s > 1   # 18 column tiles alone would leave most of 132 SMs idle
    tiles = -(-m // 64) * -(-n // (64 if dual else 128))
    assert tiles * s <= max(tiles, tq._I8_BLOCKS_PER_SM * 132)   # one resident wave at most
    assert s == tq.contraction_split(m, n, k, dual=dual, sms=132)
    # clusters that would not all run at once: the split shrinks until they do
    few = (264, 132, 88, 62, 48, 40, 34, 30)
    s_few = tq.contraction_split(m, n, k, dual=dual, sms=132, clusters=few)
    assert s_few <= s and (s_few == 1 or tiles <= few[s_few - 1])
    if s_few < s:
        assert tiles > few[s_few]   # the next larger split would not run at once


@pytest.mark.parametrize("split", [1, 2, 5, 8])
def test_sliced_contraction_matches_plain(split):
    """The kernel's fixed order written out: each slice's f32 sum over its
    rows of the contraction, the slices added in slice order, then scale and
    one rounding to bf16; held to one bf16 step of each row's max against
    the plain version (the order of an f32 sum is all that differs)."""
    rng = np.random.default_rng(40 + split)
    Mx, K, N = 7, 2312, 96
    x = torch.from_numpy(rng.normal(0, 1, (Mx, K)).astype(np.float32)).to(torch.bfloat16)
    wq = tq.quantize_int8(torch.from_numpy(rng.normal(0, 0.05, (K, N)).astype(np.float32)))
    total = torch.zeros(Mx, N)
    for a, b in _slices(K, split):
        total = total + x[:, a:b].float() @ wq["w_int8"][a:b].float()
    got = (total * wq["scale"]).to(torch.bfloat16)
    want = tq.int8_matmul_plain(x, wq)
    diff = (got.float() - want.float()).abs().amax(dim=-1)
    assert bool((diff <= BF16_TOL * want.float().abs().amax(dim=-1)).all())
