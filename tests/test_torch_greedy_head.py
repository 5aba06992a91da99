"""The tied heads' kernel (csrc/tied_head.cu) emulated with numpy on the CPU,
where it cannot run: each warpgroup's widened B tile reads back as the
table's values in their own order, for the int8 table's two 64-column
sub-steps of a 128-byte row (the TMA box under the 128-byte swizzle, a lane a
row) and the int4 table's low and high nibbles of a 64-byte row (2 rows x 4
pieces a warp); the products from the wgmma accumulator layout, the
lane-then-quad argmax of a unit, the fold of grouped int4 scales and the
two-pass reduce give the greedy heads' plain version's ids (the NaN and tie
rules of `quant._argmax_blocks` included), and the sampled heads' logits
epilogue writes back their plain version's logits. The emulation copies the
kernel's index expressions, and the B-tile and store tests check that the
source still holds them.
The plain versions are held to the Pallas kernels in tests/test_torch_ops.py
and tests/test_torch_int4.py; the kernel itself to the plain versions in
tests/test_torch_cuda.py, on the card."""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

from vlm_bridge_tpu_torch.ops import quant

UNIT = quant.ARGMAX_BLOCK_V
SOURCE = Path(quant.__file__).resolve().parents[1] / "csrc" / "tied_head.cu"


def _tma_box(raw: np.ndarray) -> np.ndarray:
    """The stage's table box in shared memory as TMA writes it, in 16-byte
    chunks: a 128-byte row under the 128-byte swizzle (chunk c at position
    c ^ (row % 8)); a 64-byte row as it lies."""
    rows, width = raw.shape
    chunks = raw.reshape(rows, width // 16, 16)
    if width != 128:
        return chunks
    box = np.empty_like(chunks)
    for r in range(rows):
        for c in range(8):
            box[r, c ^ (r % 8)] = chunks[r, c]
    return box


def _b_tile(raw: np.ndarray, j: int, widen) -> np.ndarray:
    """A warpgroup's B tile (128 rows x 8 chunks x 8 values) from sub-step j
    of the unit's stage bytes, as the kernel's `widen` stores it: piece
    q = tw + 128 it is, in a 128-byte row, row q % 128 and source chunk
    (4 j + q // 128) ^ (row % 8), else row q // 4 and chunk q % 4; its 16
    values go to chunks 2 pp and 2 pp + 1 of the row, chunk c at position
    c ^ (row % 8)."""
    box, wide = _tma_box(raw), raw.shape[1] == 128
    smem = np.full((UNIT, 8, 8), np.nan)
    for tw in range(128):
        for it in range(4):
            q = tw + 128 * it
            row = q % 128 if wide else q // 4
            pp, sw = (q // 128 if wide else q % 4), row % 8
            vals = widen(box[row, (4 * j + pp) ^ sw if wide else pp], j)
            for k in range(2):
                smem[row, (2 * pp + k) ^ sw] = vals[8 * k:8 * k + 8]
    return smem


def _read_k_major(smem: np.ndarray) -> np.ndarray:
    """What wgmma reads from a K-major tile under the 128-byte swizzle: row r's
    k-chunk c at position c ^ (r % 8)."""
    out = np.empty((smem.shape[0], 64))
    for r in range(smem.shape[0]):
        for c in range(8):
            out[r, 8 * c:8 * c + 8] = smem[r, c ^ (r % 8)]
    return out


def _lo(b):
    return ((b.astype(np.int16) & 0xF) ^ 8) - 8


def _hi(b):
    return b.astype(np.int8).astype(np.int16) >> 4


@pytest.mark.parametrize("kind,j", [("int8", 0), ("int8", 1), ("int4", 0), ("int4", 1)],
                         ids=["int8_chunk0", "int8_chunk1", "int4_low", "int4_high"])
@pytest.mark.parametrize("seed", [0, 1])
def test_widened_b_tile_reads_back_as_the_table(kind, j, seed):
    src = SOURCE.read_text()
    for expr in ("row = S::BK == 128 ? q % 128 : q / 4",
                 "pp = S::BK == 128 ? q / 128 : q % 4, sw = row % 8",
                 "tb + row * 128 + (((4 * j + pp) ^ sw) << 4)",
                 "tb + row * S::BK + 16 * pp",
                 "st_shared_v4(d + (((2 * pp) ^ sw) << 4)",
                 "st_shared_v4(d + (((2 * pp + 1) ^ sw) << 4)"):
        assert expr in src, expr
    rng = np.random.default_rng(seed)
    raw = rng.integers(-128, 128, (UNIT, 128 if kind == "int8" else 64)).astype(np.int8)
    if kind == "int8":
        def widen(b, j):
            return b.astype(np.float64)
        want = raw[:, 64 * j:64 * j + 64].astype(np.float64)
    else:
        def widen(b, j):
            return (_hi(b) if j else _lo(b)).astype(np.float64)
        want = widen(raw, j)
        lo, hi = quant.unpack_int4(torch.from_numpy(raw))   # as the port's unpacker reads them
        np.testing.assert_array_equal(want, (hi if j else lo).numpy())
    np.testing.assert_array_equal(_read_k_major(_b_tile(raw, j, widen)), want)


def _unit_best(y_unit: np.ndarray, v0: int, V: int):
    """The kernel's epilogue for one unit: y_unit [batch, 128] in the
    accumulator layout (lane t of a row holds columns 8 j + 2 t + e), each lane
    over its columns in order (a NaN sticks, strict > keeps the first), then
    the lanes t = 0..3 merged by xor shuffles 1 and 2."""
    def merge(b, a, ob, oa):
        if math.isnan(ob):
            return ob, a
        if not math.isnan(b) and (ob > b or (ob == b and oa < a)):
            return ob, oa
        return b, a

    out = []
    for row in y_unit:
        lanes = []
        for t in range(4):
            b, a = -math.inf, 2**31 - 1
            for j in range(16):
                for e in range(2):
                    v = v0 + 8 * j + 2 * t + e
                    if v < V:
                        y = row[8 * j + 2 * t + e]
                        if math.isnan(y):
                            b = y
                        elif y > b:
                            b, a = y, v
            lanes.append((b, a))
        for o in (1, 2):
            lanes = [merge(*lanes[t], *lanes[t ^ o]) for t in range(4)]
        b, a = lanes[0]
        out.append((-math.inf if math.isnan(b) else b, a))
    return out


def _reduce(bval: np.ndarray, bidx: np.ndarray) -> np.ndarray:
    """argmax_reduce_kernel: the first unit whose max is strictly greater than
    every earlier one; no winner -> 0."""
    ids = []
    for m in range(bval.shape[1]):
        best, blk = -math.inf, None
        for k in range(bval.shape[0]):
            if bval[k, m] > best:
                best, blk = bval[k, m], k
        ids.append(bidx[blk, m] if blk is not None else 0)
    return np.array(ids, dtype=np.int32)


def _emulated_ids(y: np.ndarray) -> np.ndarray:
    M, V = y.shape
    nu = -(-V // UNIT)
    bval, bidx = np.empty((nu, M)), np.zeros((nu, M), dtype=np.int64)
    yp = np.pad(y, ((0, 0), (0, nu * UNIT - V)))
    for u in range(nu):
        for m, (b, a) in enumerate(_unit_best(yp[:, u * UNIT:(u + 1) * UNIT], u * UNIT, V)):
            bval[u, m], bidx[u, m] = b, a
    return _reduce(bval, bidx)


@pytest.mark.parametrize("M,V", [(3, 300), (5, 515), (2, 128)])
def test_emulated_argmax_follows_the_plain_rules(M, V):
    rng = np.random.default_rng(M * V)
    y = rng.integers(-6, 7, (M, V)).astype(np.float32)   # many ties, across lanes and units
    y[0, min(130, V - 2)] = np.nan                        # that unit never wins row 0
    y[1, :] = np.nan                                      # no winner: 0
    y[-1, V - 1] = 100.0                                  # in the last, ragged unit
    want = quant._argmax_blocks(torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(_emulated_ids(y), want)


def _nz(v):
    """A scale below 1e-30 in magnitude counts as 1e-30 in the fold."""
    return np.where(np.abs(v) < 1e-30, np.float32(1e-30), v).astype(np.float32)


def _int4_sums(x: torch.Tensor, table: dict):
    """The kernel's sums over an int4 table, in f32: per stage of 64 packed
    bytes the low then the high nibbles' products; with grouped scales the sum
    kept in the unit of the half in hand's scale (times old / new scale,
    column by column, between halves). Returns the sums [M, V] and the factor
    that makes them logits (the last scale; per-row scales: the scales)."""
    lo, hi = (t.float().numpy() for t in quant.unpack_int4(table["w_int4"]))
    xs = x.float().numpy()
    s = table["scale"].numpy()
    group = quant._rows_group(table)
    H2 = lo.shape[1]
    acc = np.zeros((xs.shape[0], lo.shape[0]), dtype=np.float32)
    prev = None
    for c in range(H2 // 64):
        cols = slice(64 * c, 64 * c + 64)
        for half, (q, xc) in enumerate(((lo, xs[:, cols]), (hi, xs[:, H2 + 64 * c:H2 + 64 * c + 64]))):
            if group is not None:
                cur = s[half * (H2 // group) + 64 * c // group]
                if prev is not None:
                    acc = acc * (_nz(prev) / _nz(cur))
                prev = cur
            acc = acc + xc @ q[:, cols].T
    return acc, (_nz(prev) if group is not None else s)


@pytest.mark.parametrize("group", [None, 64, 128])
def test_emulated_int4_head_equals_the_plain_version(group):
    """The kernel's arithmetic on an int4 table (`_int4_sums`; a scale below
    1e-30 counts as 1e-30, per-row scales multiplied once), then the emulated
    argmax. Against int4_matmul_t_argmax_plain; a NaN scale of one group makes
    the row's logits NaN in both."""
    g = torch.Generator().manual_seed(7)
    M, V, H = 4, 300, 256
    x = torch.randn(M, H, generator=g).to(torch.bfloat16)
    table = quant.quantize_int4_rows(torch.randn(V, H, generator=g), group_size=group)
    if group is not None:
        table["scale"][1, 77] = float("nan")
    acc, final = _int4_sums(x, table)
    acc = acc * final
    want = quant.int4_matmul_t_argmax_plain(x, table).numpy()
    np.testing.assert_array_equal(_emulated_ids(acc.astype(np.float32)), want)


def _store_logits(sums: np.ndarray, final: np.ndarray, M: int, V: int):
    """The LOGITS epilogue of every unit (batch tile mb, vocab unit vb) into a
    flat y of M * V values and two units' worth past it: thread tx of the
    unit's warpgroup (lane (lg, lt) of warp lw, read from tx) holds
    acc[4 j + 2 h + e] = the unit's sum at batch row 16 lw + lg + 8 h, vocab
    column 8 j + 2 lt + e, and writes it times its column's factor rs to
    y[m * V + v], m < M and v < V, as a float2 where V is even (8-byte
    aligned). Rows past M hold zeros (x read as zeros) and columns past V
    stale factors (NaN here), as in shared memory. Returns y and the count of
    writes into each of its values."""
    nu, mt = -(-V // UNIT), -(-M // 64)
    sp = np.zeros((mt * 64, nu * UNIT), dtype=np.float32)
    sp[:M, :V] = sums
    fp = np.full(nu * UNIT, np.nan, dtype=np.float32)
    fp[:V] = final
    y = np.full(M * V + 2 * UNIT, np.inf, dtype=np.float32)
    writes = np.zeros(y.size, dtype=np.int64)
    pairs = V % 2 == 0

    def put(i, val):
        y[i] = val
        writes[i] += 1

    for mb in range(mt):
        for vb in range(nu):
            tile, rs = sp[mb * 64:mb * 64 + 64, vb * UNIT:vb * UNIT + UNIT], fp[vb * UNIT:vb * UNIT + UNIT]
            wg = vb % 2   # the warpgroup of the unit in its pair
            for tx in range(128 * wg, 128 * wg + 128):
                lt, lg, lw = tx % 4, (tx % 32) // 4, (tx // 32) % 4
                acc = [tile[16 * lw + lg + 8 * h, 8 * j + 2 * lt + e]
                       for j in range(16) for h in range(2) for e in range(2)]
                v0 = vb * UNIT + 2 * lt
                for h in range(2):
                    m = mb * 64 + 16 * lw + lg + 8 * h
                    if m >= M:
                        continue
                    i0 = m * V + v0
                    for j in range(16):
                        f = rs[8 * j + 2 * lt:8 * j + 2 * lt + 2]
                        y0, y1 = acc[4 * j + 2 * h] * f[0], acc[4 * j + 2 * h + 1] * f[1]
                        v, i = v0 + 8 * j, i0 + 8 * j
                        if pairs and v + 1 < V:
                            assert i % 2 == 0
                            put(i, y0)
                            put(i + 1, y1)
                        else:
                            if v < V:
                                put(i, y0)
                            if v + 1 < V:
                                put(i + 1, y1)
    return y, writes


@pytest.mark.parametrize("V", [300, 301])
@pytest.mark.parametrize("kind,group", [("int8", None), ("int4", None), ("int4", 64),
                                        ("int4", 128)],
                         ids=["int8", "int4_channel", "int4_g64", "int4_g128"])
def test_emulated_logits_store_writes_the_plain_version(kind, group, V):
    """The sampled heads' epilogue on the kernel's sums (int8: the products
    times the per-row scales; int4 per row or the grouped fold's final factor)
    at 70 batch rows (two tiles, the second ragged) and V off the 128-row unit,
    even (float2 stores) and odd (one value at a time): every logit is written
    once, nothing past row M or column V, and y is the plain version's within
    the card tests' LOGIT_TOL / LOGIT4_TOL of a row's largest value. The
    kernel source holds the store's index expressions."""
    src = SOURCE.read_text()
    for expr in ("const int lt = tx % 4, lg = (tx % 32) / 4, lw = (tx / 32) % 4;",
                 "const int v0 = vb * TH_UNIT + 2 * lt;",
                 "const int m = mb * 64 + 16 * lw + lg + 8 * h;",
                 "float* yp = out + (size_t)m * V + v0;",
                 "if (m >= M) continue;",
                 "ld_shared_f2(rsa + 4 * (8 * j + 2 * lt))",
                 "y0 = acc[4 * j + 2 * h] * f.x, y1 = acc[4 * j + 2 * h + 1] * f.y;",
                 "const int v = v0 + 8 * j;",
                 "const bool pairs = V % 2 == 0;",
                 "if (pairs && v + 1 < V) {",
                 "(yp + 8 * j), make_float2(y0, y1)",
                 "if (v < V) __stcs(yp + 8 * j, y0);",
                 "if (v + 1 < V) __stcs(yp + 8 * j + 1, y1);",
                 # the factors: the per-row scales of the pair, or the grouped fold's last row
                 "sc + 4 * (GROUPED ? TH_RING * 2 * TH_UNIT + ((i % 2) * 2 + 1) * TH_UNIT",
                 ": (pair_no % 2) * TH_UNIT));"):
        assert expr in src, expr
    g = torch.Generator().manual_seed(V)
    M, H = 70, 256
    x = torch.randn(M, H, generator=g).to(torch.bfloat16)
    w = torch.randn(V, H, generator=g)
    if kind == "int8":
        table = quant.quantize_int8(w, axis=1)
        sums = x.float().numpy() @ table["w_int8"].float().numpy().T
        final, plain, tol = table["scale"].numpy(), quant.int8_matmul_t_plain, 1e-5
    else:
        table = quant.quantize_int4_rows(w, group_size=group)
        (sums, final), plain, tol = _int4_sums(x, table), quant.int4_matmul_t_plain, 2e-5
    y, writes = _store_logits(sums.astype(np.float32), final, M, V)
    np.testing.assert_array_equal(writes, np.r_[np.ones(M * V, np.int64), np.zeros(2 * UNIT, np.int64)])
    assert np.isinf(y[M * V:]).all()
    got, want = y[:M * V].reshape(M, V), plain(x, table).numpy()
    err = np.abs(got - want).max(axis=1) / np.abs(want).max(axis=1)
    assert err.max() <= tol, err.max()
