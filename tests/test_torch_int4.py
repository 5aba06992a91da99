"""PyTorch port, the int4 recipe on the CPU, held to the JAX package on the
same numpy-seeded inputs:

- the quantizers bit for bit (packed bytes and f32 scales of `quantize_int4`
  and `quantize_int4_rows` with and without groups, `repack_down_blockwise`,
  `unpack_int4`, the three dequantizers, `take_int4_rows`);
- the plain `int4_matmul_t`, `int4_matmul_t_argmax` and `int4_mlp` (what the
  CPU runs and what the CUDA kernels are held to on the card) against the
  Pallas kernels in interpret mode and against the jnp fallbacks;
- `decode_step_stacked` with int4 MLP weights against the JAX stacked step in
  interpret mode and against the port's own per-layer path on the
  dequantized int4 grid;
- greedy ids of the whole recipe (`embedding4`, `mlp_int4`) against the JAX
  package's fused path in interpret mode;
- `from_jax` on int4 dicts, the packed fragment order, and the guards.

Tolerances. f32 logits: LOGIT_TOL x max|ref| (the Pallas bodies round x to
bf16; the inputs here are bf16-exact, so only the summation order differs).
`int4_mlp` rounds its hidden and its output to bf16 on both sides: one bf16
step (2^-7) of max|ref|.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from vlm_bridge_tpu.configs import Gemma2Config, VLMConfig
from vlm_bridge_tpu.inference import generate as JG
from vlm_bridge_tpu.models import bridge as jb
from vlm_bridge_tpu.models import full_model as jfm
from vlm_bridge_tpu.models import gemma2 as jg
from vlm_bridge_tpu.ops import decode_kernels as jdk
from vlm_bridge_tpu.ops import quant as jq
from vlm_bridge_tpu_torch.inference import generate as TG
from vlm_bridge_tpu_torch.models import gemma2 as tg
from vlm_bridge_tpu_torch.ops import decode_kernels as tdk
from vlm_bridge_tpu_torch.ops import quant as tq
from vlm_bridge_tpu_torch.params.from_jax import config_from_jax as P
from vlm_bridge_tpu_torch.params.from_jax import from_jax

LOGIT_TOL, BF16_TOL = 2e-3, 2.0 ** -7


def _np(tree):
    return {k: (np.array(v) if isinstance(v, jax.Array) else v) for k, v in tree.items()}


def _same(got: dict, want: dict):
    """The port's dict equals the JAX dict: same keys, bytes, scales, tags."""
    want = _np(want)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].numpy().dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
        else:
            assert got[k] == v and type(got[k]) is type(v), k


def _weights(seed, shape):
    w = np.random.default_rng(seed).normal(0, 0.05, shape).astype(np.float32)
    w.flat[::97] *= 6.0   # outliers, so that groups matter
    w[3] = 0.0            # an all-zero row / group: the 1e-12 floor
    return w


# ---------------------------------------------------------------------------
# quantizers, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("group", [None, 8, 32])
def test_quantize_int4_bit_equal(group):
    w = _weights(0, (64, 40))
    want = jq.quantize_int4(jnp.asarray(w), group_size=group)
    got = tq.quantize_int4(torch.from_numpy(w), group_size=group)
    _same(got, want)
    assert tq.is_quantized_int4(got) and not tq.is_quantized_int4_rows(got) or group is None
    np.testing.assert_array_equal(tq.dequantize_int4(got).numpy(),
                                  np.asarray(jq.dequantize_int4(want)))
    lo, hi = tq.unpack_int4(got["w_int4"])
    jlo, jhi = jq.unpack_int4(want["w_int4"])
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    assert lo.dtype == torch.int8 and int(lo.min()) >= -7 and int(hi.max()) <= 7


def test_quantize_int4_axis1_and_refusals():
    w = _weights(1, (24, 64))
    _same(tq.quantize_int4(torch.from_numpy(w), axis=1), jq.quantize_int4(jnp.asarray(w), axis=1))
    np.testing.assert_array_equal(
        tq.dequantize_int4(tq.quantize_int4(torch.from_numpy(w), axis=1), axis=1).numpy(),
        np.asarray(jq.dequantize_int4(jq.quantize_int4(jnp.asarray(w), axis=1), axis=1)))
    with pytest.raises(ValueError, match="axis=0"):
        tq.quantize_int4(torch.from_numpy(w), axis=1, group_size=8)
    with pytest.raises(ValueError, match="group_size"):
        tq.quantize_int4(torch.from_numpy(w), group_size=5)
    with pytest.raises(ValueError, match="even"):
        tq.quantize_int4(torch.zeros(7, 4))


@pytest.mark.parametrize("group", [None, 16])
def test_quantize_int4_rows_bit_equal(group):
    w = _weights(2, (50, 64))
    want = jq.quantize_int4_rows(jnp.asarray(w), group_size=group)
    got = tq.quantize_int4_rows(torch.from_numpy(w), group_size=group)
    _same(got, want)
    assert got["scale"].is_contiguous()
    assert tq.is_quantized_int4_rows(got) and tq._rows_group(got) == group
    np.testing.assert_array_equal(tq.dequantize_int4_rows(got).numpy(),
                                  np.asarray(jq.dequantize_int4_rows(want)))
    ids = np.array([[0, 3, 49], [7, 7, 1]])
    np.testing.assert_array_equal(tq.take_int4_rows(got, torch.from_numpy(ids)).numpy(),
                                  np.asarray(jq.take_int4_rows(want, jnp.asarray(ids))))
    assert not tq.is_quantized_int4_rows({"w_int8": got["w_int4"], "scale": got["scale"]})


@pytest.mark.parametrize("group,block_f", [(None, 16), (8, 16), (8, 32)])
def test_repack_down_blockwise_bit_equal(group, block_f):
    w = _weights(3, (64, 24))
    jd = jq.repack_down_blockwise(jq.quantize_int4(jnp.asarray(w), group_size=group),
                                  block_f=block_f)
    td = tq.repack_down_blockwise(tq.quantize_int4(torch.from_numpy(w), group_size=group),
                                  block_f=block_f)
    _same(td, jd)
    np.testing.assert_array_equal(
        tq.dequantize_int4_blockwise(td, block_f=block_f).numpy(),
        np.asarray(jq.dequantize_int4_blockwise(jd, block_f=block_f)))
    # the block-local order holds the same weight as the global one
    np.testing.assert_array_equal(
        tq.dequantize_int4_blockwise(td, block_f=block_f).numpy(),
        tq.dequantize_int4(tq.quantize_int4(torch.from_numpy(w), group_size=group)).numpy())
    with pytest.raises(ValueError, match="packing"):
        tq.repack_down_blockwise(td, block_f=block_f)
    with pytest.raises(ValueError, match="packing"):
        tq.dequantize_int4_blockwise(td, block_f=2 * block_f)
    with pytest.raises(ValueError, match="packing"):
        tq.dequantize_int4(td)


def test_embedding4_part_and_embed_match_jax():
    for H, group in ((64, None), (256, 128)):
        emb = _weights(4, (40, H))
        want = jg.quantize_embedding_part(jnp.asarray(emb), ("embedding4", "mlp"))
        got = tg.quantize_embedding_part(torch.from_numpy(emb), ("embedding4", "mlp"))
        _same(got, want)
        assert tq._rows_group(got) == group
        ids = np.array([[1], [39]])
        np.testing.assert_array_equal(
            tg.embed({"embedding": got}, torch.from_numpy(ids)).numpy(),
            np.asarray(jg.embed({"embedding": want}, jnp.asarray(ids))))
    with pytest.raises(ValueError, match="mutually exclusive"):
        tg.quantize_embedding_part(torch.zeros(4, 8), ("embedding", "embedding4"))


def test_from_jax_carries_int4_dicts():
    w = _weights(5, (64, 32))
    jq4 = jq.repack_down_blockwise(jq.quantize_int4(jnp.asarray(w), group_size=8), block_f=16)
    rows = jq.quantize_int4_rows(jnp.asarray(w), group_size=16)
    tree = {"lm": {"embedding": _np(rows)}, "down": _np(jq4),
            "plain": _np(jq.quantize_int4(jnp.asarray(w)))}
    got = from_jax(tree)
    _same(got["down"], jq4)
    _same(got["lm"]["embedding"], rows)
    assert got["down"]["packing"] == "blockwise16" and got["down"]["group_size"] == 8
    assert got["plain"]["packing"] == "global" and got["plain"]["group_size"] is None
    assert tq.is_quantized_int4_rows(got["lm"]["embedding"])
    np.testing.assert_array_equal(
        tq.dequantize_int4_blockwise(got["down"], block_f=16).numpy(),
        np.asarray(jq.dequantize_int4_blockwise(jq4, block_f=16)))


# ---------------------------------------------------------------------------
# the plain versions against the Pallas kernels (interpret) and the fallbacks
# ---------------------------------------------------------------------------


def _bf16_exact(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


HEAD_CASES = [(5, 333, 256, None), (5, 333, 256, 128), (9, 1000, 512, 128)]


@pytest.mark.parametrize("M,V,H,group", HEAD_CASES,
                         ids=[f"M{m}_V{v}_H{h}_g{g}" for m, v, h, g in HEAD_CASES])
@pytest.mark.parametrize("interpret", [True, False], ids=["pallas_interpret", "jnp_fallback"])
def test_int4_heads_plain_match_jax(monkeypatch, M, V, H, group, interpret):
    """H a multiple of 256 (the Pallas gate), a ragged V; a tie and a NaN row
    for the argmax."""
    monkeypatch.setattr(jq, "INTERPRET", interpret)
    rng = np.random.default_rng(6)
    x = _bf16_exact(rng.normal(0, 1, (M, H)))
    table = jq.quantize_int4_rows(jnp.asarray(_weights(7, (V, H))), group_size=group)
    assert jq._int4_mmt_pallas_ok(table)
    tt = from_jax(_np(table))
    want = np.asarray(jq.int4_matmul_t(jnp.asarray(x, jnp.bfloat16), table))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    for fn in (tq.int4_matmul_t, tq.int4_matmul_t_plain):
        got = fn(xt, tt)
        assert got.dtype == torch.float32 and tuple(got.shape) == (M, V)
        # the jnp fallback rounds the dequantized table to bf16; the kernel does not
        tol = LOGIT_TOL if interpret else 2.0 ** -7
        assert float(np.abs(got.numpy() - want).max()) <= tol * float(np.abs(want).max())

    # argmax: rows 30 and 300 (other blocks of 128) made equal winners of row 1
    tie = _np(table)
    row = (np.sign(x[1]) * 7).astype(np.int8)
    for v in (30, 300):
        tie["w_int4"][v] = (row[:H // 2] & 0xF) | (row[H // 2:] << 4)
        tie["scale"][..., v] = 0.05
    xn = x.copy()
    xn[2] = np.nan
    want_ids = np.asarray(jq.int4_matmul_t_argmax(jnp.asarray(xn, jnp.bfloat16), _j(tie)))
    xt = torch.from_numpy(xn).to(torch.bfloat16)
    for fn in (tq.int4_matmul_t_argmax, tq.int4_matmul_t_argmax_plain):
        got = fn(xt, from_jax(tie))
        assert got.dtype == torch.int32 and int(got[1]) == 30
        if interpret:     # the kernel's NaN rule: no block wins -> 0 (the fallback gives jnp's)
            assert int(got[2]) == 0 == int(want_ids[2])
        keep = np.arange(M) != 2
        np.testing.assert_array_equal(got.numpy()[keep], want_ids[keep])
    assert tq.int4_matmul_t_argmax.launches == 0 and tq.int4_matmul_t.launches == 0


def _j(tree):
    return {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v) for k, v in tree.items()}


@pytest.mark.parametrize("group", [None, 128])
@pytest.mark.parametrize("interpret", [True, False], ids=["pallas_interpret", "jnp_fallback"])
def test_int4_mlp_plain_matches_jax(monkeypatch, group, interpret):
    monkeypatch.setattr(jq, "INTERPRET", interpret)
    M, H, F, block_f = 5, 256, 1024, 256 if group is None else 512
    rng = np.random.default_rng(8)
    x = _bf16_exact(rng.normal(0, 1, (M, H)))
    gate, up = (jq.quantize_int4(jnp.asarray(_weights(s, (H, F))), group_size=group)
                for s in (9, 10))
    down = jq.repack_down_blockwise(
        jq.quantize_int4(jnp.asarray(_weights(11, (F, H))), group_size=group), block_f=block_f)
    want = np.asarray(jq.int4_mlp(jnp.asarray(x, jnp.bfloat16), gate, up, down,
                                  block_f=block_f).astype(jnp.float32))
    tgate, tup, tdown = (from_jax(_np(q)) for q in (gate, up, down))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    for fn in (tq.int4_mlp, tq.int4_mlp_plain):
        got = fn(xt, tgate, tup, tdown, block_f=block_f)
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == (M, H)
        err = float(np.abs(got.float().numpy() - want).max())
        # the fallback also rounds the dequantized weights to bf16: two steps
        assert err <= (1 if interpret else 2) * BF16_TOL * float(np.abs(want).max()), err
    assert tq.int4_mlp.launches == 0
    # f32 in, f32 out: the same algebra as the JAX fallback at f32
    monkeypatch.setattr(jq, "INTERPRET", False)
    want32 = np.asarray(jq.int4_mlp(jnp.asarray(x), gate, up, down, block_f=block_f))
    got32 = tq.int4_mlp(torch.from_numpy(x), tgate, tup, tdown, block_f=block_f).numpy()
    assert float(np.abs(got32 - want32).max()) <= 1e-5 * float(np.abs(want32).max())


def test_int4_mlp_refuses_what_the_jax_function_refuses():
    w = torch.from_numpy(_weights(12, (64, 128)))
    gate, up = tq.quantize_int4(w), tq.quantize_int4(w)
    down_g = tq.quantize_int4(torch.from_numpy(_weights(13, (128, 64))))
    down = tq.repack_down_blockwise(down_g, block_f=64)
    x = torch.zeros(2, 64)
    assert tuple(tq.int4_mlp(x, gate, up, down, block_f=64).shape) == (2, 64)
    with pytest.raises(ValueError, match="repack_down_blockwise"):
        tq.int4_mlp(x, gate, up, down_g, block_f=64)          # globally packed down
    with pytest.raises(ValueError, match="repack_down_blockwise"):
        tq.int4_mlp(x, gate, up, down, block_f=128)           # another block width
    with pytest.raises(ValueError, match="globally"):
        tq.int4_mlp(x, {**gate, "packing": "blockwise64"}, up, down, block_f=64)
    with pytest.raises(ValueError, match="group_size"):
        tq.int4_mlp(x, gate, tq.quantize_int4(w, group_size=8), down, block_f=64)
    with pytest.raises(ValueError, match="shapes"):
        tq.int4_mlp(torch.zeros(2, 32), gate, up, down, block_f=64)
    with pytest.raises(ValueError, match="rows-packed"):
        tq.int4_matmul_t(x, gate)


# ---------------------------------------------------------------------------
# int4_mlp's kernel (csrc/int8_linear.cu, the product kernel's int4 path)
# written out: its split plan and its walk over stages, sub-steps and slices
# ---------------------------------------------------------------------------

TILE_K = 64   # packed rows a stage (tq._I8_TILE_K)

# (M, N, Kp, dual): Gemma-2-2B's gate | up (F 9216 over H/2 = 1152 packed rows)
# and down (H 2304 over F/2 = 4608) at the decode batch, one row and 128 rows,
# rows past the int8 decode form's 128, a ragged column tile, the tiny shapes
# below; Gemma-2-2B's other products (fused qkv, o, the bridge's self qkv) as
# if packed, a shape with enough tiles that it is not split, and one stage
INT4_SPLIT_CASES = [(64, 9216, 1152, True), (64, 2304, 4608, False), (1, 9216, 1152, True),
                    (1, 2304, 4608, False), (130, 2304, 4608, False), (300, 2320, 1152, False),
                    (65, 1040, 512, True), (5, 256, 512, False), (5, 1024, 128, True),
                    (128, 9216, 1152, True), (128, 2304, 4608, False), (64, 4096, 1152, False),
                    (64, 2304, 1024, False), (64, 6912, 1152, False), (3200, 4096, 1152, False),
                    (1, 16, 64, False)]


def _int4_slices(Kp: int, split: int) -> list:
    """The product kernel's slices (unit_of): slice s takes the stages
    [s stages // split, (s + 1) stages // split), as packed-row ranges."""
    stages = Kp // TILE_K
    return [(s * stages // split * TILE_K, (s + 1) * stages // split * TILE_K)
            for s in range(split)]


@pytest.mark.parametrize("shape", INT4_SPLIT_CASES,
                         ids=[f"{m}x{n}x{k}{'_dual' * d}" for m, n, k, d in INT4_SPLIT_CASES])
def test_int4_split_plan(shape):
    """At most one cluster's 8 slices, none empty, covering the packed rows in
    order; no more blocks than one resident wave; a split whose clusters would
    not all run at once shrinks; a pure function of its arguments."""
    m, n, kp, dual = shape
    assert TILE_K == tq._I8_TILE_K
    s = tq.int4_split(m, n, kp, dual=dual, sms=132)
    assert 1 <= s <= 8
    slices = _int4_slices(kp, s)
    assert slices[0][0] == 0 and slices[-1][1] == kp
    assert all(a < b for a, b in slices)
    assert all(slices[i][1] == slices[i + 1][0] for i in range(s - 1))
    tiles = -(-m // 64) * -(-n // (64 if dual else 128))
    assert tiles * s <= max(tiles, 2 * 132)
    if (m, n, kp) == (64, 2304, 4608):
        assert s == 8      # 18 column tiles: down is split over a whole cluster
    if (m, n, kp) == (64, 9216, 1152):
        assert s == 1      # 144 tiles of gate | up fill the card alone
    if m > 128 and tiles < 132:
        assert s > 1       # the int4 path splits past the int8 decode form's rows
    if tiles >= 2 * 132:
        assert s == 1      # enough tiles for every SM's two blocks: not split
    assert s == tq.int4_split(m, n, kp, dual=dual, sms=132)
    few = (264, 132, 88, 62, 48, 40, 34, 30)
    s_few = tq.int4_split(m, n, kp, dual=dual, sms=132, clusters=few)
    assert s_few <= s and (s_few == 1 or tiles <= few[s_few - 1])


def _nibbles(packed: np.ndarray):
    w = packed.astype(np.int32)
    return (((w & 0xF) ^ 8) - 8).astype(np.float32), (w >> 4).astype(np.float32)


def _kernel_walk(x, q: dict, half: int, split: int) -> np.ndarray:
    """The f32 sums one int4 product of the kernel leaves for its epilogue:
    slice by slice, stage by stage (64 packed rows from p0), the low nibbles
    against x at depth lo(p0) = p0 // half * 2 half + p0 % half, then the high
    ones against lo(p0) + half; in groups, the sum kept in the unit of the
    sub-step's scale (times old over new at each change, times the last at
    the end; a scale below 1e-30 counts as 1e-30); the slices added in rank
    order. All in f32, as the kernel's accumulators are."""
    lo_n, hi_n = _nibbles(np.asarray(q["w_int4"]))
    scale, group = np.asarray(q["scale"], np.float32), q["group_size"]
    kp = lo_n.shape[0]

    def nz(v):
        return np.where(np.abs(v) < 1e-30, np.float32(1e-30), v).astype(np.float32)

    total = np.zeros((x.shape[0], lo_n.shape[1]), np.float32)
    for s0, s1 in _int4_slices(kp, split):
        subs = [(p0, h) for p0 in range(s0, s1, TILE_K) for h in (0, 1)]
        depth = [p0 // half * 2 * half + p0 % half + h * half for p0, h in subs]
        acc = np.zeros_like(total)
        for n, ((p0, h), d0) in enumerate(zip(subs, depth)):
            w = (hi_n if h else lo_n)[p0:p0 + TILE_K]
            acc = (acc + x[:, d0:d0 + TILE_K] @ w).astype(np.float32)
            if group is not None:
                cur = nz(scale[d0 // group])
                f = cur / nz(scale[depth[n + 1] // group]) if n + 1 < len(subs) else cur
                acc = (acc * f).astype(np.float32)
        total = (total + acc).astype(np.float32)
    return total


def _gelu_tanh(v):
    return (0.5 * v * (1.0 + np.tanh(0.7978845608028654 * (v + 0.044715 * v ** 3)))).astype(
        np.float32)


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("block_f,group,splits", [(256, None, (1, 1)), (512, None, (2, 3)),
                                                  (256, 64, (2, 8)), (512, 64, (1, 5))])
def test_int4_kernel_walk_matches_jax(monkeypatch, block_f, group, splits):
    """The kernel's walk (`_kernel_walk`) through both products, GeGLU with
    the per-channel scales (or 1 where groups scaled the sums), the hidden
    rounded to bf16, down's sums times its scale, rounded to bf16: held to
    JAX's int4_mlp, its Pallas kernel in interpret mode, within one bf16 step
    (2^-7) of max|ref| (the hidden may round the other way on a tie)."""
    monkeypatch.setattr(jq, "INTERPRET", True)
    M, H, F = 5, 256, 1024
    rng = np.random.default_rng(30 + block_f + (group or 0))
    x = _bf16_exact(rng.normal(0, 1, (M, H)))
    gate, up = (jq.quantize_int4(jnp.asarray(_weights(s, (H, F))), group_size=group)
                for s in (31, 32))
    down = jq.repack_down_blockwise(
        jq.quantize_int4(jnp.asarray(_weights(33, (F, H))), group_size=group), block_f=block_f)
    want = np.asarray(jq.int4_mlp(jnp.asarray(x, jnp.bfloat16), gate, up, down,
                                  block_f=block_f).astype(jnp.float32))
    gate, up, down = (_np(q) for q in (gate, up, down))
    g = _kernel_walk(x, gate, H // 2, splits[0])
    u = _kernel_walk(x, up, H // 2, splits[0])
    if group is None:
        g, u = g * gate["scale"], u * up["scale"]
    hidden = _bf16(_gelu_tanh(g) * u)
    y = _kernel_walk(hidden, down, block_f // 2, splits[1])
    got = _bf16(y if group is not None else y * down["scale"])
    err = float(np.abs(got - want).max())
    assert err <= BF16_TOL * float(np.abs(want).max()), err
    # a walk that took the high nibbles' x from lo(p0) + H/2 for down, as if
    # down were packed globally, is far off: the test sees the index map
    wrong = _bf16(_kernel_walk(hidden, down, F // 2, splits[1])
                  * (1.0 if group is not None else down["scale"]))
    assert float(np.abs(wrong - want).max()) > 10 * BF16_TOL * float(np.abs(want).max())


# ---------------------------------------------------------------------------
# the stack step with int4 MLP weights
# ---------------------------------------------------------------------------


def _lm_cfg():
    return dataclasses.replace(Gemma2Config.tiny_test(), sliding_window=128)


def test_packed_fragment_order_round_trips():
    q = torch.from_numpy(np.random.default_rng(14).integers(-7, 8, (192, 128)).astype(np.int8))
    f = tdk.to_fragments4(q)
    assert f.dtype == torch.int8 and tuple(f.shape) == tdk.frag4_shape(192, 128) == (2, 3, 128, 16)
    assert torch.equal(tdk.from_fragments4(f), q)
    # a lane's low nibbles are its int8 fragment bytes of the first 32 rows of
    # each 64, its high nibbles those of the next 32
    lo, hi = tq.unpack_int4(f)
    assert torch.equal(lo[:, 0], tdk.to_fragments(q[:32])[:, 0])
    assert torch.equal(hi[:, 2], tdk.to_fragments(q[160:192])[:, 0])
    with pytest.raises(ValueError, match="multiples of 64"):
        tdk.to_fragments4(q[:96])


@pytest.mark.parametrize("group", [None, 16])
def test_decode_step_stacked_int4_mlp_matches_jax(monkeypatch, group):
    """Three steps of the port's stacked step with int4 MLP weights: against
    the JAX stacked step (Pallas, interpret mode; it rounds the matmul inputs
    to bf16) at 0.03 x max|ref|, as the JAX package's own test allows, and
    against the port's per-layer path on the dequantized int4 grid (both f32)
    at 1e-3. The stack holds the JAX package's nibbles and scales."""
    cfg = _lm_cfg()
    qj = jax.jit(lambda k: jg.quantize_params(jg.init(k, cfg, dtype=jnp.float32)))(
        jax.random.key(0))
    st_j = jg.stack_decode_params(qj, cfg, mlp_int4=True, mlp_int4_group=group)
    qt = from_jax(jax.tree.map(np.asarray, qj))
    st_t = tg.stack_decode_params(qt, P(cfg), mlp_int4=True, mlp_int4_group=group)
    assert "wgu" not in st_t and st_t["gu_scale4"].shape[1] == (
        1 if group is None else cfg.hidden_size // group)

    # the same int4 grid on both sides: layer 0's gate against the JAX stack's
    H, F = cfg.hidden_size, cfg.intermediate_size
    vals = tdk.split_gate_up(tdk.from_fragments4(st_t["wgu4"][0]))[0]   # runs of 32 columns
    jlo, jhi = jq.unpack_int4(st_j["gate4"][0])
    np.testing.assert_array_equal(vals.numpy(),
                                  np.concatenate([np.asarray(jlo), np.asarray(jhi)], axis=0))
    jscale = np.asarray(st_j["gu_scale4"][0])            # [2 or 2 H/g, F]: gate rows, then up
    gate_s, up_s = tdk.split_gate_up(st_t["gu_scale4"][0])
    np.testing.assert_array_equal(gate_s.numpy(), jscale[:jscale.shape[0] // 2])
    np.testing.assert_array_equal(up_s.numpy(), jscale[jscale.shape[0] // 2:])
    np.testing.assert_array_equal(st_t["d_scale4"][0].numpy().reshape(-1, H),
                                  np.asarray(st_j["down_scale4"][0]).reshape(-1, H))

    # the port's per-layer reference: float MLP weights = the dequantized int4 grid
    ref = {k: v for k, v in qt.items() if k != "layers"}
    ref["layers"] = {}
    for name, lp in qt["layers"].items():
        mlp = {k: tq.dequantize_int4(tq.quantize_int4(tq.dequantize(lp["mlp"][k], axis=0),
                                                      group_size=group))
               for k in ("gate", "up", "down")}
        ref["layers"][name] = {**lp, "mlp": mlp}

    B, L = 4, 16
    rng = np.random.default_rng(13)
    c_j = jg.StackedKVCache.zeros(cfg, B, L)
    c_t = tg.StackedKVCache.zeros(P(cfg), B, L)
    c_ref = tg.KVCache.zeros(P(cfg), B, L, dtype=torch.int8)
    monkeypatch.setattr(jdk, "INTERPRET", True)
    step_j = jax.jit(lambda tok, c, t: jg.decode_step_stacked(qj, cfg, st_j, tok, c, t))
    for t in range(3):
        tok = rng.normal(0, 1, (B, 1, H)).astype(np.float32)
        h_j, c_j = step_j(jnp.asarray(tok), c_j, jnp.int32(t))
        h_t, c_t = tg.decode_step_stacked(qt, P(cfg), st_t, torch.from_numpy(tok), c_t, t)
        h_r, c_ref = tg.decode_step(ref, P(cfg), torch.from_numpy(tok), c_ref, position=t)
        scale = float(np.abs(np.asarray(h_j)).max())
        np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=0.03 * scale, rtol=0,
                                   err_msg=f"vs the JAX stacked step, t={t}")
        np.testing.assert_allclose(h_t.numpy(), h_r.numpy(), atol=1e-3 * scale, rtol=0,
                                   err_msg=f"vs the port's per-layer path, t={t}")
    assert tdk.fused_stack_step.launches == 0


def test_stack_decode_params_int4_refusals():
    cfg = _lm_cfg()
    g = torch.Generator().manual_seed(0)
    q = tg.quantize_params(tg.init(P(cfg), generator=g, dtype=torch.float32))
    with pytest.raises(ValueError, match="mlp_int4_group"):
        tg.stack_decode_params(q, P(cfg), mlp_int4=True, mlp_int4_group=128)
    st = tg.stack_decode_params(q, P(cfg), mlp_int4=True, mlp_int4_group=None)
    x = torch.zeros(2, cfg.hidden_size)
    c = tg.StackedKVCache.zeros(P(cfg), 2, 4)
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
              attn_scale=cfg.attn_scale, softcap=cfg.attn_logit_softcap, eps=cfg.rms_norm_eps)
    cos, sin = torch.ones(cfg.head_dim), torch.zeros(cfg.head_dim)
    with pytest.raises(ValueError, match="neither"):
        tdk.fused_stack_step(0, x, {k: v for k, v in st.items() if k != "wgu4"}, *c, cos, sin,
                             **kw)
    # float MLP weights pass straight to the int4 grid (no int8 step between)
    lp = q["layers"]["0"]
    fl = {**q, "layers": {**q["layers"], "0": {**lp, "mlp": {
        k: tq.dequantize(v, axis=0) for k, v in lp["mlp"].items()}}}}
    st_f = tg.stack_decode_params(fl, P(cfg), mlp_int4=True, mlp_int4_group=16)
    st_q = tg.stack_decode_params(q, P(cfg), mlp_int4=True, mlp_int4_group=16)
    assert torch.equal(st_f["wgu4"], st_q["wgu4"]) and torch.equal(st_f["d_scale4"],
                                                                    st_q["d_scale4"])


# ---------------------------------------------------------------------------
# the whole recipe
# ---------------------------------------------------------------------------

MAX_NEW = 6


@pytest.fixture(scope="module")
def recipe():
    base = VLMConfig.tiny_test()
    cfg = dataclasses.replace(base, lm=dataclasses.replace(base.lm, sliding_window=128))

    @jax.jit
    def build(key):
        p = jfm.init(key, cfg, frozen_dtype=jnp.float32)
        return {**p, "lm": jg.quantize_params(p["lm"], ("embedding4", "mlp", "attn")),
                "bridge": jb.quantize_decode_params(p["bridge"])}

    q = jax.tree.map(np.array, build(jax.random.key(3)))
    pixels = np.random.default_rng(0).normal(
        0, 1, (3, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    return cfg, q, from_jax(q), pixels


@pytest.mark.parametrize("group", [None, 16])
def test_int4_recipe_greedy_ids_match_jax(recipe, monkeypatch, group):
    """--quantize embedding4,mlp,attn,bridge + int8 KV + mlp_int4 at f32: the
    port's ids against the JAX package's fused path (Pallas kernels in
    interpret mode)."""
    cfg, q, qt, pixels = recipe
    assert "w_int4" in q["lm"]["embedding"] and tq.is_quantized_int4_rows(qt["lm"]["embedding"])
    monkeypatch.setattr(jdk, "INTERPRET", True)
    monkeypatch.setattr(jq, "INTERPRET", True)
    kw = dict(max_length=MAX_NEW, greedy=True, kv_quant=True, mlp_int4=True,
              mlp_int4_group=group)
    want, want_len = JG.generate_tokens(q, cfg, pixel_values=jnp.asarray(pixels),
                                        gen=JG.GenerationConfig(**kw),
                                        activation_dtype=jnp.float32)
    got, got_len = TG.generate_tokens(qt, P(cfg), pixel_values=torch.from_numpy(pixels),
                                      gen=TG.GenerationConfig(**kw),
                                      activation_dtype=torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert tq.int4_matmul_t_argmax.launches == 0


def test_int4_recipe_guards_and_prestack(recipe):
    from vlm_bridge_tpu_torch.tools.loading import prestack_decode_params

    cfg, q, qt, pixels = recipe
    px = torch.from_numpy(pixels[:1])
    gen4 = TG.GenerationConfig(max_length=MAX_NEW, greedy=True, kv_quant=True, mlp_int4=True,
                               mlp_int4_group=16)
    # mlp_int4 anywhere but on the fused stack raises: nothing serves int8 under its label
    for gen in (dataclasses.replace(gen4, kv_quant=False),
                dataclasses.replace(gen4, force_jnp=True)):
        with pytest.raises(ValueError, match="fused stack"):
            TG.generate_tokens(qt, P(cfg), pixel_values=px, gen=gen)
    served = prestack_decode_params(qt, P(cfg), gen4)
    assert "wgu4" in served["lm"]["stacked_decode"] and "layers" not in served["lm"]
    run = lambda p, g: TG.generate_tokens(p, P(cfg), pixel_values=px, gen=g,  # noqa: E731
                                          activation_dtype=torch.float32)[0]
    assert torch.equal(run(served, gen4), run(qt, gen4))
    # a stack built for the other setting is refused, in both directions
    with pytest.raises(ValueError, match="restack"):
        run(served, dataclasses.replace(gen4, mlp_int4=False))
    served8 = prestack_decode_params(qt, P(cfg), dataclasses.replace(gen4, mlp_int4=False))
    with pytest.raises(ValueError, match="restack"):
        run(served8, gen4)
    # the sampled head on the int4 table: f32 logits through int4_matmul_t
    hidden = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (2, 1, cfg.lm.hidden_size)).astype(np.float32))
    want = np.asarray(jg.logits_from_hidden(q["lm"] and {"embedding": _j(q["lm"]["embedding"])},
                                            cfg.lm, jnp.asarray(hidden.numpy())))
    got = tg.logits_from_hidden(qt["lm"], P(cfg.lm), hidden)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * float(np.abs(want).max()), rtol=0)
