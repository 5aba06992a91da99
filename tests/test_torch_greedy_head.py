"""The greedy heads' kernel (csrc/greedy_head.cu) emulated with numpy on the
CPU, where it cannot run: each warpgroup's widened B tile reads back as the
table's values in their own order, for the int8 table's two 64-column
sub-steps of a 128-byte row (the TMA box under the 128-byte swizzle, a lane a
row) and the int4 table's low and high nibbles of a 64-byte row (2 rows x 4
pieces a warp); the products from the wgmma accumulator layout, the
lane-then-quad argmax of a unit, the fold of grouped int4 scales and the
two-pass reduce give the plain version's ids (the NaN and tie rules of
`quant._argmax_blocks` included). The emulation copies the kernel's index
expressions, and the B-tile test checks that the source still holds them.
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
SOURCE = Path(quant.__file__).resolve().parents[1] / "csrc" / "greedy_head.cu"


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


@pytest.mark.parametrize("group", [None, 64, 128])
def test_emulated_int4_head_equals_the_plain_version(group):
    """The kernel's arithmetic on an int4 table, in f32: per stage of 64 packed
    bytes the low then the high nibbles' products; with grouped scales the sum
    kept in the unit of the half in hand's scale (times old / new scale,
    column by column, between halves; times the last scale at the end; a
    scale below 1e-30 counts as 1e-30), with per-row scales multiplied once;
    then the emulated argmax. Against int4_matmul_t_argmax_plain; a NaN scale
    of one group makes the row's logits NaN in both."""
    g = torch.Generator().manual_seed(7)
    M, V, H = 4, 300, 256
    x = torch.randn(M, H, generator=g).to(torch.bfloat16)
    table = quant.quantize_int4_rows(torch.randn(V, H, generator=g), group_size=group)
    if group is not None:
        table["scale"][1, 77] = float("nan")
    lo, hi = (t.float().numpy() for t in quant.unpack_int4(table["w_int4"]))
    xs = x.float().numpy()
    s = table["scale"].numpy()
    H2 = H // 2

    def nz(v):
        return np.where(np.abs(v) < 1e-30, np.float32(1e-30), v).astype(np.float32)

    acc = np.zeros((M, V), dtype=np.float32)
    prev = None
    for c in range(H2 // 64):
        cols = slice(64 * c, 64 * c + 64)
        for half, (q, xc) in enumerate(((lo, xs[:, cols]), (hi, xs[:, H2 + 64 * c:H2 + 64 * c + 64]))):
            if group is not None:
                cur = s[half * (H2 // group) + 64 * c // group]
                if prev is not None:
                    acc = acc * (nz(prev) / nz(cur))
                prev = cur
            acc = acc + xc @ q[:, cols].T
    acc = acc * (nz(prev) if group is not None else s)
    want = quant.int4_matmul_t_argmax_plain(x, table).numpy()
    np.testing.assert_array_equal(_emulated_ids(acc.astype(np.float32)), want)
