"""PyTorch port, the decode GEMM core's stream-K split (csrc/decode_gemm.cuh):
the workspace size (`stream_k_workspace`) and the order in which a stage
adds each tile's slots (`stream_k_tiles`, the kernel's closed forms) against
a brute-force walk of the units that each block of the grid runs, as the
kernel's loop runs them.
The kernel itself runs only on the card (tests/test_torch_cuda.py holds two
calls' bits equal there)."""

import pytest

from vlm_bridge_tpu_torch.ops import decode_kernels as dk

# (M, N, K): the products of the stack step at Gemma-2-2B's and -27B's widths
# (q|k|v, o, gate|up, down), the bridge step's (q / o, q|k|v, fc1, fc2), the
# small widths of the cuda tests; at the batch sizes the tests use
GEMMA2_2B = [(4096, 2304), (2304, 2048), (18432, 2304), (2304, 9216)]
GEMMA2_27B = [(4096 + 2 * 2048, 4608), (4608, 4096), (73728, 4608), (4608, 36864)]
BRIDGE = [(2304, 2304), (3 * 2304, 2304), (9216, 2304), (2304, 9216)]
SMALL = [(448, 384), (768, 256), (256, 512), (1024, 256), (64, 64)]
CASES = [(M, N, K, sms) for M in (1, 3, 64, 65) for N, K in GEMMA2_2B + BRIDGE + SMALL
         for sms in (132,)] + [(64, N, K, 132) for N, K in GEMMA2_27B] + [
    (64, N, K, sms) for N, K in GEMMA2_2B[:2] + SMALL for sms in (1, 7, 114)]


def _brute_force_runs(M, N, K, sms):
    """Walk every block's units [u0, u1) in tile-major order, cutting them
    into runs of one tile: (block, tile, first unit, end unit, the run is the
    block's first)."""
    chunks = K // dk.DG_BK
    tiles = -(-M // 64) * -(-N // dk.DG_BN)
    units = tiles * chunks
    grid = min(sms, units)
    runs = []
    for b in range(grid):
        u0, u1 = b * units // grid, (b + 1) * units // grid
        assert u1 > u0, "a block with no units"
        u = u0
        while u < u1:
            tile = u // chunks
            end = min(u1, (tile + 1) * chunks)
            runs.append((b, tile, u, end, u == u0))
            u = end
    return runs, tiles, chunks, grid


@pytest.mark.parametrize("M,N,K,sms", CASES, ids=[f"M{m}_N{n}_K{k}_sms{s}" for m, n, k, s in CASES])
def test_stream_k_plan_matches_a_brute_force_walk(M, N, K, sms):
    runs, tiles, chunks, grid = _brute_force_runs(M, N, K, sms)
    slots, words = dk.stream_k_workspace(M, N, K, sms)
    assert words == 2   # the grid barrier's count and generation
    # the brute force's order of each tile's sum: its runs in block order,
    # each stored in the slot of its tile and block
    want = [[] for _ in range(tiles)]
    for b, tile, u, end, first in runs:
        want[tile].append((b, tile + b))
    assert dk.stream_k_tiles(M, N, K, sms) == want
    used = [s for plan in want for _, s in plan]
    assert len(used) == len(set(used)), "two runs share a slot"
    assert all(0 <= s < slots for s in used) and slots == tiles + grid - 1
    # a tile's contributors are consecutive blocks, one run each
    for plan in want:
        blocks = [b for b, _ in plan]
        assert blocks == list(range(blocks[0], blocks[-1] + 1))
    # a block runs one tile's part, or the end of one and the start of the
    # next, or whole tiles between: its runs cover its units exactly once
    for b in range(grid):
        u0, u1 = b * (tiles * chunks) // grid, (b + 1) * (tiles * chunks) // grid
        mine = sorted((u, end) for bb, _, u, end, _ in runs if bb == b)
        assert mine[0][0] == u0 and mine[-1][1] == u1
        assert all(e == s for (_, e), (s, _) in zip(mine, mine[1:]))


def test_stream_k_workspace_at_gemma2_2b_batch_64():
    """The stack step's workspace at batch 64 on an H100's 132 SMs: gate|up's
    96 + 131 = 227 slots of 48 KB (11.16 MB) and the barrier's two words;
    q|k|v splits each tile over 6 blocks, o and down over 11, gate|up over
    2-3."""
    sizes = [dk.stream_k_workspace(64, N, K, 132) for N, K in GEMMA2_2B]
    assert max(s for s, _ in sizes) == 227 and max(c for _, c in sizes) == 2
    assert 227 * dk.DG_SLOT * 4 == 11_157_504
    spread = [sorted({len(p) for p in dk.stream_k_tiles(64, N, K, 132)}) for N, K in GEMMA2_2B]
    assert spread == [[6], [11], [2, 3], [11]]
