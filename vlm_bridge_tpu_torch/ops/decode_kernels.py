"""Fused decode steps (port of vlm_bridge_tpu.ops.decode_kernels).

`fused_stack_step` runs one token through every Gemma-2 decoder layer and
`fused_bridge_step` through both bridge blocks. On CUDA tensors each
launches the hand-written kernels of csrc/stack_step.cu / csrc/bridge_step.cu
(one C call per token that launches every layer's kernels); on CPU tensors
each runs its plain PyTorch version (`*_plain`, same signature), which is
also the reference the kernels are held to on the card.

Both versions keep everything inside a step in f32: the residual stream,
the norms, the projection inputs and outputs, the softmaxes. The input and
output are in the activation dtype (x.dtype; bf16 on the card) and so is
the bridge's self cache. The kernels feed each f32 projection input to the
bf16 tensor cores as two halves (hi + lo, csrc/common.cuh), so they agree with the plain
versions to f32 rounding, which greedy decoding needs on near-ties. At f32
activations this is the JAX jnp-int8 decode path's algebra; the TPU kernels
instead round projection inputs to bf16.

`fused_attn_step` and `fused_mlp_step` are one decoder layer's two halves
(the per-layer fused decode, models/gemma2.decode_step_fused), over the
per-layer int8 dicts {"w_int8" [in, out], "scale" [out]} as quantize_params
makes them (csrc/layer_step.cu on CUDA tensors). They share the stack step's
algebra and differ from it in where they round, as the TPU kernels do: the
per-layer steps round the normed input h, the attention output and the MLP
hidden to bf16 before each product (one bf16 operand a product) and the
residual stream to x.dtype at the end of each half, twice a layer; the stack
step keeps f32 between its stages (hi + lo halves) and across all layers.
Their plain versions round at the same places. In the sources, the per-layer
steps run their four products on the stack step's GEMM core
(csrc/decode_gemm.cuh) fed one bf16 half, over the weights in fragment
order: `layer_fragments` adds those forms to a layer's dicts
("w_frag"; gate|up interleaved as "gu_frag" / "gu_scale" on the gate dict),
once per model (tools/loading.prepare_fused_layers); a CUDA call on dicts
without them raises. The plain versions read "w_int8" / "scale".

Layouts are this port's own (not the TPU's head-major/64-row/8-row-window
ones). Every stacked int8 weight [K, N] ([in, out]) is stored in wgmma
register-fragment order, `to_fragments(w)` = [N/64, K/32, 128, 16] (see
there):
  stacked LM weights (models/gemma2.stack_decode_params):
    wqkv [L, *frag(H, QHD+2KHD)] + qkv_scale [L, QHD+2KHD],
    wo [L, *frag(QHD, H)] + o_scale [L, H], wgu [L, *frag(H, 2F)] + gu_scale
    [L, 2F] (gate and up columns interleaved in runs of GU_RUN = 32,
    `interleave_gate_up`, so that every 64-column tile of the kernel holds
    both halves of its 32 features), wd [L, *frag(F, H)] + d_scale [L, H],
    norms [L, 4, H] f32 (input / post-attn / pre-FFN / post-FFN).
  with routed experts (a Gemma2MoEConfig decoder) the MLP fields are instead
    router [L, H, E] f32, ewgu [L, *frag(H, E 2F)] + egu_scale [L, E 2F] (each
    expert's gate|up interleaved as wgu, the experts side by side), ewd
    [L, *frag(E F, H)] (the experts' down weights stacked along the
    contraction) + ed_scale [L, E, H] (each expert's own per-column scales).
  with int4 MLP weights (stack_decode_params(mlp_int4=True)) the MLP fields
    are instead wgu4 [L, *frag4(H, 2F)] + gu_scale4 [L, H/g, 2F] (interleaved
    as wgu) and wd4 [L, *frag4(F, H)] + d_scale4 [L, F/g, H]: nibbles in the packed fragment
    order of `to_fragments4`, scales per group of g rows of the contraction,
    or one row of scales (per output channel) when the second dim is 1. The
    TPU layout's pairing of row k with k + K/2, its block-local down
    projection and its MLP chunk width serve Mosaic's tiling and are not
    copied; the nibbles' values and the scales are the same.
  LM KV cache: K/V [L, B, KH, S, D] int8, scales [L, B, KH, S] f32.
  stacked bridge weights (models/bridge.stack_bridge_decode_params):
    lns [nb, 6, ld]; wq/wo_c/wo_s [nb, *frag(ld, ld)], wqkv
    [nb, *frag(ld, 3ld)], fc1 [nb, *frag(ld, F)], fc2 [nb, *frag(F, ld)],
    each with *_scale and *_bias [nb, N] f32.
  bridge caches: cross K/V [nb, B, Hc, Sv, Dc] int8 + scales
    [nb, B, Hc, Sv]; self K/V [nb, B, Hs, Smax, Ds] in the activation dtype.
The caches are updated in place at row t.

Given a `StepGraphs` (a decode loop's, inference/generate.py), each step
runs its C call from a CUDA graph of its position: captured on the first
call, after the validation, and replayed on the later ones (the counters
`captures` and `replays` beside `launches`).

With routed experts the MLP half of a layer is three launches: the routing
(`moe_route_kernel`: router logits in f32 from the pre-FFN-normed row,
softmax, the top k with ties to the lower index, the weights renormalized
where the config says so; written as a dense [B, E] weight matrix, zero
where a row does not route), then gate|up of all experts as one product
over their side-by-side columns with GeGLU times each row's weight for the
column's expert as its stage (`moe_expert_kernel<false>`), then down of all
experts as one product over their stacked rows, each expert's rows under
its own scales (`moe_expert_kernel<true>`), with the post-FFN stage. A row
that does not route to an expert feeds it zeros, so the sum over the
contraction is the weighted sum of the row's k experts, in expert order.
Every expert's weights are read once a step; the products compute all B
rows against each expert (`moe_slot_rows` of them): 1 + 6 L launches a
step. With no host synchronisation, the routing kernel adds the rows routed
to each (layer, expert) into a device counter (`moe_counters`) and writes
the weights of position t into a routing log (`moe_route_log`).

Each step launches one kernel for each product, which also runs the stage
that consumes it (csrc/decode_gemm.cuh: the residual norms, GeGLU, GELU),
the attentions as kernels of their own that read the q|k|v (or q) product
where it lies, and one row kernel for the first norm: 1 + 5 L launches a
stack step, 1 + 8 nb a bridge step; `fused_attn_step` 4 (the pre-norm,
q|k|v, the attention, o with the post-norm and residual), `fused_mlp_step`
3 (the pre-norm, gate|up with GeGLU, down with the post-norm and
residual). The norms hold a row, up to ROW_MAX wide (every configuration of
configs.py). The attention kernels keep each head's logits and the rows'
scales in shared memory: the wrappers refuse a position or a head layout
whose logits do not fit (`_stack_attn_bytes`, `_cross_attn_bytes`,
`_layer_attn_bytes`), more query heads a kv head than `stack_attn_heads` allows, stack heads
other than 32, 64, 128, 256 or 512 wide, bridge self-attention heads other
than 32, 64, 128 or 256 wide, and per-layer heads whose width is not a
multiple of 32 up to 1024, or with more than D / 32 query heads a kv head.
"""

from __future__ import annotations

from functools import partial

import torch

from vlm_bridge_tpu_torch.ops import cuda_lib
from vlm_bridge_tpu_torch.ops.layers import gelu_exact, gelu_tanh
from vlm_bridge_tpu_torch.ops.quant import _pack_nibbles, unpack_int4

ROW_MAX = 256 * 64   # csrc/common.cuh: ROW_MAX


def _check_row_width(h: int) -> None:
    if h > ROW_MAX:
        raise ValueError(f"rows of {h} values: the row kernels hold at most {ROW_MAX}")


def _rms(v: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """f32 RMSNorm with Gemma's (1 + w) weighting."""
    return v * torch.rsqrt(v.square().mean(-1, keepdim=True) + eps) * (1.0 + w)


def _ln(v: torch.Tensor, s: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    """f32 LayerNorm, mean-subtracting with biased variance (torch form)."""
    mu = v.mean(-1, keepdim=True)
    d = v - mu
    return d * torch.rsqrt(d.square().mean(-1, keepdim=True) + eps) * s + b


def to_fragments(w: torch.Tensor) -> torch.Tensor:
    """int8 [K, N] ([in, out]) -> [N/64, K/32, 128, 16], the order in which
    csrc/i8_gemm.cu reads it: the weights are wgmma's A operand, W^T, taken
    from registers, so output columns are its 64-row M side. For columns
    64c..64c+63 and rows 32r..32r+31, lane l (g = l // 4, t = l % 4) of warp
    w holds 16 contiguous bytes: for k16 steps s = 0, 1 its A fragment of
    columns n = 64c + 16w + (g, g + 8) and rows k = 32r + 16s + (2t, 2t+1,
    2t+8, 2t+9), in the order (k 2t, n g), (2t+1, g), (2t, g+8), (2t+1, g+8),
    (2t+8, g), (2t+9, g), (2t+8, g+8), (2t+9, g+8): two bf16x2 registers a
    word once widened."""
    K, N = w.shape
    if K % 32 or N % 64:
        raise ValueError(f"weight {K}x{N}: K must be a multiple of 32, N of 64")
    v = w.reshape(K // 32, 2, 2, 4, 2, N // 64, 4, 2, 8)   # r, s, k8, t, i, c, w, n8, g
    return v.permute(5, 0, 6, 8, 3, 1, 2, 7, 4).reshape(N // 64, K // 32, 128, 16).contiguous()


def from_fragments(wf: torch.Tensor) -> torch.Tensor:
    """Inverse of `to_fragments`: [N/64, K/32, 128, 16] -> [K, N]."""
    C, R = wf.shape[:2]
    v = wf.reshape(C, R, 4, 8, 4, 2, 2, 2, 2)              # c, r, w, g, t, s, k8, n8, i
    return v.permute(1, 5, 6, 4, 8, 0, 2, 7, 3).reshape(32 * R, 64 * C)


def frag_shape(K: int, N: int) -> tuple:
    return (N // 64, K // 32, 128, 16)


def to_fragments4(q: torch.Tensor) -> torch.Tensor:
    """int4 values (int8 in -8..7) [K, N] -> packed [N/64, K/64, 128, 16], the
    order in which csrc/i4_gemm.cu reads them: the 16 bytes of a lane hold
    its `to_fragments` bytes of rows 64r..64r+31 in their low nibbles and of
    rows 64r+32..64r+63 in their high nibbles (four k16 steps)."""
    K, N = q.shape
    if K % 64 or N % 64:
        raise ValueError(f"weight {K}x{N}: K and N must be multiples of 64")
    v = q.reshape(K // 64, 2, 32, N)
    return _pack_nibbles(to_fragments(v[:, 0].reshape(K // 2, N)),
                         to_fragments(v[:, 1].reshape(K // 2, N)))


def from_fragments4(wf: torch.Tensor) -> torch.Tensor:
    """Inverse of `to_fragments4`: packed [N/64, K/64, 128, 16] -> int8 [K, N]."""
    lo, hi = (from_fragments(h) for h in unpack_int4(wf))
    K2, N = lo.shape
    return torch.stack([lo.reshape(K2 // 32, 32, N), hi.reshape(K2 // 32, 32, N)],
                       dim=1).reshape(2 * K2, N)


def frag4_shape(K: int, N: int) -> tuple:
    return (N // 64, K // 64, 128, 16)


GU_RUN = 32   # gate and up columns alternate in runs of this many


def interleave_gate_up(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """[..., F] and [..., F] -> [..., 2F]: runs of GU_RUN gate columns, each
    followed by the same run of up columns (the stacked gate|up layout:
    columns 64 i .. 64 i + 31 are gate 32 i .., 64 i + 32 .. 64 i + 63 up
    32 i ..), so that a 64-column tile of the product holds both halves of
    its features and GeGLU runs where the tile's sums are final."""
    F = gate.shape[-1]
    if F % GU_RUN or up.shape != gate.shape:
        raise ValueError(f"gate and up of {F} and {up.shape[-1]} columns: both must be "
                         f"equal and a multiple of {GU_RUN}")
    lead = gate.shape[:-1]
    return torch.stack([gate.reshape(*lead, F // GU_RUN, GU_RUN),
                        up.reshape(*lead, F // GU_RUN, GU_RUN)], dim=-2).reshape(*lead, 2 * F)


def split_gate_up(gu: torch.Tensor) -> tuple:
    """Inverse of `interleave_gate_up`: [..., 2F] -> (gate, up)."""
    lead, F2 = gu.shape[:-1], gu.shape[-1]
    v = gu.reshape(*lead, F2 // (2 * GU_RUN), 2, GU_RUN)
    return v[..., 0, :].reshape(*lead, F2 // 2), v[..., 1, :].reshape(*lead, F2 // 2)


def _mm4(a: torch.Tensor, wf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """f32 a @ (w_int4 * scale), w in packed fragment order, scale [K/g, N]
    (one row: per output channel)."""
    w = from_fragments4(wf).float()
    return a @ (w * scale.repeat_interleave(w.shape[0] // scale.shape[0], dim=0))


def _mlp4_group(stacked: dict, H: int):
    """Rows of the contraction that share a scale in an int4 stack, from the
    scales' shapes alone (None: one scale per output channel)."""
    rows = stacked["gu_scale4"].shape[1]
    return None if rows == 1 else H // rows


def _mm(a: torch.Tensor, wf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """f32 (a @ w_int8) * scale, w given in fragment order."""
    return (a @ from_fragments(wf).float()) * scale


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., half:], x[..., :half]], dim=-1) * sin


# ---------------------------------------------------------------------------
# The fused steps' GEMM core, alone
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# The GEMM core's stream-K split (csrc/decode_gemm.cuh)
# ---------------------------------------------------------------------------

DG_BN, DG_BK = 192, 64    # a block's weight columns; K rows a work unit
DG_SLOT = 64 * DG_BN      # f32 values a workspace slot: one run's partial tile
DG_XATTN_THREADS = 320    # threads of a cross-attention block
DG_GMAX = 4               # query heads a kv head the stack's attention kernel takes
DG_GMAX_WIDE = 8          # ... at head width 128
# the stages' shared memory: the int8 instantiation's ring of 7 stages and its
# epilogue staging
DG_STAGE_SMEM = 7 * (2 * 64 * DG_BK * 2 + 3 * 64 * DG_BK) + 32 * (DG_BN + 4) * 4


def stack_attn_heads(D: int) -> int:
    """The most query heads a kv head the stack's attention kernel takes at
    head width D (csrc/decode_gemm.cuh:stack_attn_fits)."""
    return DG_GMAX_WIDE if D == 128 else min(D // 32, DG_GMAX)


def _stack_attn_bytes(G: int, D: int, t: int) -> int:
    """Shared memory of the stack's attention kernel at position t
    (csrc/decode_gemm.cuh:stack_attn_floats)."""
    n = t + 1
    return 4 * ((G + 2) * D + (G + 1) * D + D // 2 + 2 * n + G * n + 4096 * G + 32)


def _cross_attn_bytes(D: int, S: int) -> int:
    """Shared memory of the cross-attention kernel over S vision rows
    (csrc/decode_gemm.cuh:cross_attn_floats)."""
    return 4 * (D + 3 * S + (DG_XATTN_THREADS // (D // 16)) * D + 32)


def _layer_attn_bytes(G: int, D: int, t: int) -> int:
    """Shared memory of the per-layer steps' attention kernel at position t
    (csrc/layer_step.cu:layer_attn_floats)."""
    return 4 * ((G + 2) * D + (G + 1) * D + G * D + D // 2 + 2 * t + G * t + 2 * G
                + 4096 * 2 + 32)


def _units(M: int, N: int, K: int) -> tuple:
    """(tiles, units) of a product: 64-row x DG_BN-column tiles, DG_BK rows
    of K a unit."""
    tiles = -(-M // 64) * -(-N // DG_BN)
    return tiles, tiles * (K // DG_BK)


def stream_k_workspace(M: int, N: int, K: int, sms: int) -> tuple:
    """(slots, words) the GEMM core needs for one [M, K] @ [K, N] product on
    `sms` SMs: its grid is min(sms, units) blocks; the run of block b in tile
    t stores into slot t + b (a tile's contributors are consecutive blocks),
    so tiles + grid - 1 slots; and the grid barrier's two words."""
    tiles, units = _units(M, N, K)
    return tiles + min(sms, units) - 1, 2


def stream_k_tiles(M: int, N: int, K: int, sms: int) -> list:
    """For each tile in order, the blocks whose runs add into it, in the
    order of the sum, with the slot each stores its partial sums in: the
    closed forms of csrc/decode_gemm.cuh (block_of, product4, the
    epilogue's slot)."""
    tiles, units = _units(M, N, K)
    chunks, grid = K // DG_BK, min(sms, units)

    def block_of(x):
        return ((x + 1) * grid - 1) // units

    return [[(b, tile + b) for b in range(block_of(tile * chunks),
                                         block_of(tile * chunks + chunks - 1) + 1)]
            for tile in range(tiles)]


# one workspace for each (device, stream, slots, words): the barrier's count
# is zero between launches, so it is allocated once, with zeros
_WORKSPACES: dict = {}


def _workspace_size(dev: torch.device, shapes) -> tuple:
    """(slots, barrier words) of one workspace for products of the given
    (M, N, K) shapes launched one after another."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    sizes = [stream_k_workspace(M, N, K, sms) for M, N, K in shapes]
    return max(a for a, _ in sizes), max(b for _, b in sizes)


def _workspace(dev: torch.device, shapes) -> tuple:
    """The cached stream-K workspace for products of the given (M, N, K)
    shapes launched one after another on the current stream, with its slot
    and barrier-word counts."""
    slots, counters = _workspace_size(dev, shapes)
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream, slots, counters)
    ws = _WORKSPACES.get(key)
    if ws is None:
        ws = _WORKSPACES[key] = torch.zeros(slots * DG_SLOT + counters, dtype=torch.float32,
                                            device=dev)
    return ws, slots, counters


# scratch tensors of the per-layer steps, one for each (device, stream, name,
# shape): the calls on one stream run one after another
_SCRATCH: dict = {}


def _scratch(dev: torch.device, name: str, shape: tuple, dtype: torch.dtype,
             zero: bool = False) -> torch.Tensor:
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream, name, shape, dtype)
    buf = _SCRATCH.get(key)
    if buf is None:
        buf = _SCRATCH[key] = (torch.zeros if zero else torch.empty)(shape, dtype=dtype, device=dev)
    return buf


class StepGraphs:
    """The buffers of one fused step at fixed addresses, and its CUDA graphs,
    one a position: what `fused_stack_step` and `fused_bridge_step` take as
    `graphs` (a decode loop holds one of each, inference/generate.py).

    `x` is the step's input, which the caller writes before each call. The
    wrapper's output, its scratch and its stream-K workspace are allocated
    here at the first capture that needs them, outside the capture, and
    kept. The first call at position t validates its arguments and captures
    the step's one C call, with t and the launch parameters that follow from
    it as host values, into position t's graph; a later call at t with the
    same tensors (the same addresses, shapes and scalars: `signature`)
    replays it: the same kernels in the same order, with no validation and no
    per-launch work on the host. The workspace's barrier count is zero after
    every launch, as between eager calls; its release flag takes each
    launch's epoch, which a graph fixes at capture: a step launches at least
    three products with a barrier, so no launch ever follows one with its own
    epoch, and a waiter never passes on a stale release."""

    def __init__(self, x: torch.Tensor):
        self.x = x
        self._buffers: dict = {}
        self._graphs: dict = {}   # t -> (signature, CUDAGraph, output)
        self._stream = self._pool = None

    def buffer(self, name: str, shape: tuple, dtype: torch.dtype, zero: bool = False):
        key = (name, tuple(shape), dtype)
        buf = self._buffers.get(key)
        if buf is None:
            make = torch.zeros if zero else torch.empty
            buf = self._buffers[key] = make(shape, dtype=dtype, device=self.x.device)
        return buf

    def workspace(self, shapes) -> tuple:
        """As `_workspace`, but this step's own, zeroed once."""
        slots, counters = _workspace_size(self.x.device, shapes)
        ws = self.buffer("ws", (slots * DG_SLOT + counters,), torch.float32, zero=True)
        return ws, slots, counters

    @staticmethod
    def signature(tensors, weights: dict, *scalars) -> tuple:
        return (tuple((a.data_ptr(), a.shape) for a in tensors),
                tuple(w.data_ptr() for w in weights.values()), scalars)

    def replay(self, t: int, sig: tuple):
        """Position t's output after replaying its graph, or None where no
        graph of t was captured with these arguments."""
        entry = self._graphs.get(t)
        if entry is None or entry[0] != sig:
            return None
        entry[1].replay()
        return entry[2]

    def capture(self, t: int, sig: tuple, launch, out: torch.Tensor) -> None:
        """Capture `launch` (the step's C call) as position t's graph on a
        side stream, then replay it once: capturing runs nothing."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.x.device)
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self._stream):
            # relaxed: the C call binds its device and sets kernel attributes
            # on its first use, neither of which is stream work
            graph.capture_begin(pool=self._pool, capture_error_mode="relaxed")
            try:
                launch()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass
                raise
            graph.capture_end()
        self._graphs[t] = (sig, graph, out)
        graph.replay()

    @property
    def positions(self) -> list:
        return sorted(self._graphs)


def _step_buffers(graphs, dev: torch.device):
    """new(name, shape, dtype): a fresh tensor, or the graphs' own buffer."""
    if graphs is None:
        return lambda name, shape, dtype: torch.empty(shape, dtype=dtype, device=dev)
    return graphs.buffer


def _run_step(graphs, t: int, sig, counts, name: str, args: tuple, out: torch.Tensor) -> None:
    """Run C entry `name` directly, or capture it as position t's graph of
    `graphs` (counted on `counts`, the wrapper) and replay it."""
    if graphs is None:
        cuda_lib.call(name, *args)
        return
    graphs.capture(t, sig, lambda: cuda_lib.call(name, *args), out)
    counts.captures += 1


def split_halves(a: torch.Tensor) -> torch.Tensor:
    """f32 [M, K] -> [2, M, K] bf16: hi = bf16(a), lo = bf16(a - hi), the two
    halves in which the fused steps feed a product (csrc/common.cuh)."""
    hi = a.to(torch.bfloat16)
    return torch.stack([hi, (a - hi.float()).to(torch.bfloat16)])


def decode_gemm_plain(a2, wf, scale, bias=None):
    """Plain version of `decode_gemm`."""
    y = _mm(a2.float().sum(0), wf, scale)
    return y if bias is None else y + bias


def decode_gemm4_plain(a2, wf4, scale):
    """Plain version of `decode_gemm4`."""
    return _mm4(a2[0].float() + a2[1].float(), wf4, scale)


def _gemm_out(a2, N: int, out):
    M = a2.shape[1]
    if out is None:
        return torch.zeros(M, N, dtype=torch.float32, device=a2.device)
    cuda_lib.check(out, "out", torch.float32, (M, N))
    return out


def decode_gemm(a2, wf, scale, bias=None, out=None):
    """y[M, N] = ((a2[0] + a2[1]) @ w_int8) * scale (+ bias): one product of
    the fused steps alone. a2: [2, M, K] bf16 halves (`split_halves`), or
    [1, M, K]: one bf16 half, the per-layer steps' form (y = (a2[0] @ w_int8)
    * scale (+ bias)); wf: w [K, N] in fragment order (`to_fragments`);
    scale, bias: f32 [N]. CUDA tensors run csrc/i8_gemm.cu, which adds into
    `out` (zeros if not given: a caller that passes it zeroes it) and returns
    it; CPU tensors run the plain version."""
    if not a2.is_cuda:
        return decode_gemm_plain(a2, wf, scale, bias)
    halves, M, K = a2.shape
    N = 64 * wf.shape[0]
    if K % 64 or wf.shape[1] * 32 != K:
        raise ValueError(f"depth {K} must be a multiple of 64 and match the fragments")
    if halves not in (1, 2):
        raise ValueError(f"a2 holds {halves} halves: 1 (bf16) or 2 (hi + lo)")
    c = cuda_lib.check
    c(a2, "a2", torch.bfloat16, (halves, M, K))
    c(wf, "wf", torch.int8, frag_shape(K, N))
    c(scale, "scale", torch.float32, (N,))
    if bias is not None:
        c(bias, "bias", torch.float32, (N,))
    y = _gemm_out(a2, N, out)
    ws, slots, counters = _workspace(a2.device, [(M, N, K)])
    p = cuda_lib.ptr
    cuda_lib.call("vbt_i8_gemm", p(a2), p(wf), p(scale), 0 if bias is None else p(bias), p(y),
                  p(ws), slots, counters, halves, M, N, K)
    decode_gemm.launches += 1
    return y


decode_gemm.launches = 0


def decode_gemm4(a2, wf4, scale, out=None):
    """y[M, N] = sum over scale groups of ((a2[0] + a2[1])[:, group] @
    w_int4[group]) * scale[group]: the int4 product of the stack step alone.
    wf4: w [K, N] in packed fragment order (`to_fragments4`); scale
    [K / g, N] f32 (one row: per output channel), g a multiple of 32. CUDA
    tensors run csrc/i4_gemm.cu (adds into `out`, as `decode_gemm`); CPU
    tensors run the plain version."""
    if not a2.is_cuda:
        return decode_gemm4_plain(a2, wf4, scale)
    _, M, K = a2.shape
    N, groups = 64 * wf4.shape[0], scale.shape[0]
    if K % 64 or wf4.shape[1] * 64 != K or K % groups or (K // groups) % 32:
        raise ValueError(f"depth {K} and {groups} scale groups: K must be a multiple of 64, "
                         "a group of a multiple of 32 rows")
    c = cuda_lib.check
    c(a2, "a2", torch.bfloat16, (2, M, K))
    c(wf4, "wf4", torch.int8, frag4_shape(K, N))
    c(scale, "scale", torch.float32, (groups, N))
    y = _gemm_out(a2, N, out)
    ws, slots, counters = _workspace(a2.device, [(M, N, K)])
    p = cuda_lib.ptr
    cuda_lib.call("vbt_i4_gemm", p(a2), p(wf4), p(scale), p(y), p(ws), slots, counters,
                  K // groups, M, N, K)
    decode_gemm4.launches += 1
    return y


decode_gemm4.launches = 0


# ---------------------------------------------------------------------------
# Whole decoder stack
# ---------------------------------------------------------------------------


def moe_route(logits: torch.Tensor, k: int, norm: bool) -> tuple:
    """Routing of rows by their router logits [N, E]: p = softmax in f32,
    the k largest p in order (ties to the lower index), their weights
    p_sel / sum(p_sel) where `norm` (else p_sel). Returns (weights [N, k]
    f32, experts [N, k] int64). The plain version of the routing kernel's
    choice (csrc/stack_step.cu:moe_route_kernel) and the eager model's."""
    p = torch.softmax(logits.float(), dim=-1)
    experts = torch.sort(p, dim=-1, descending=True, stable=True).indices[:, :k]
    sel = p.gather(-1, experts)
    return (sel / sel.sum(dim=-1, keepdim=True) if norm else sel), experts


def moe_dense_weights(weights: torch.Tensor, experts: torch.Tensor, E: int) -> torch.Tensor:
    """[N, k] weights of experts [N, k] -> [N, E], zero where a row does not
    route (what the routing kernel writes)."""
    return torch.zeros(weights.shape[0], E, dtype=torch.float32,
                       device=weights.device).scatter_(1, experts, weights.float())


def moe_slot_rows(B: int) -> int:
    """Rows the expert products compute against each expert of a step of B
    rows: every row, in tiles of 64."""
    return -(-B // 64) * 64


# the routing counters and logs of eager calls (graphs=None): a counter for each
# (device, L, E), a log for each (device, S, L, B, E), the latest call's last
_MOE_COUNTERS: dict = {}
_MOE_LOGS: dict = {}


def _moe_buffers(graphs, dev: torch.device, S: int, L: int, B: int, E: int) -> tuple:
    """(rows routed [L, E] int64, routing log [S, L, B, E] f32) on the
    device: the step graphs' own, or those of eager calls."""
    if graphs is not None:
        return (graphs.buffer("moe_rows", (L, E), torch.int64, zero=True),
                graphs.buffer("moe_log", (S, L, B, E), torch.float32, zero=True))
    rows = _MOE_COUNTERS.get((str(dev), L, E))
    if rows is None:
        rows = _MOE_COUNTERS[(str(dev), L, E)] = torch.zeros(L, E, dtype=torch.int64, device=dev)
    key = (str(dev), S, L, B, E)
    log = _MOE_LOGS.pop(key, None)
    _MOE_LOGS[key] = log = log if log is not None else torch.zeros(S, L, B, E, device=dev)
    return rows, log


def moe_counters(graphs=None, reset: bool = False) -> dict:
    """The routing counter on the host: {"rows": [L, E] rows routed to each
    (layer, expert)}, summed since it was last reset, of `graphs` (a decode
    session's stack StepGraphs) or of the eager calls (summed over their
    shapes; empty where nothing was routed). Reading it waits for the
    device: call it after a batch's tokens are on the host. reset: zero it
    after the read. (The row slots the products compute are known on the
    host: `moe_slot_rows` a step, layer and expert.)"""
    if graphs is not None:
        bufs = [b for (name, _, _), b in graphs._buffers.items() if name == "moe_rows"]
    else:
        bufs = list(_MOE_COUNTERS.values())
    out = {}
    for buf in bufs:
        host = buf.to("cpu", copy=True)
        same = "rows" in out and out["rows"].shape == host.shape
        out["rows"] = out["rows"] + host if same else host
        if reset:
            buf.zero_()
    return out


def moe_route_log(graphs=None):
    """The routing log on the device, [S, L, B, E] f32: at [t, l] the weight
    each row gave each expert in layer l at position t (zero where it did not
    route), as the latest step at t wrote it; of `graphs` (a decode
    session's stack StepGraphs) or of the latest eager call's shape. None
    where nothing was routed. The device writes it with no host
    synchronisation: a copy taken after a batch's steps holds that batch's
    routing."""
    if graphs is not None:
        logs = [b for (name, _, _), b in graphs._buffers.items() if name == "moe_log"]
        return logs[-1] if logs else None
    return next(reversed(_MOE_LOGS.values()), None)


def _moe_mlp_plain(t: int, i: int, h: torch.Tensor, stacked: dict, k: int, norm: bool,
                   bufs: tuple) -> torch.Tensor:
    """One layer's routed feed-forward of the plain stack step at position t:
    f32 h [B, H] -> [B, H] (the experts' weighted sum, before the post-FFN
    norm); bufs: the counter and the log (`_moe_buffers`)."""
    B = h.shape[0]
    E = stacked["router"].shape[2]
    F = 32 * stacked["ewd"].shape[2] // E
    # the routing kernel reads h as the products do: its bf16 hi + lo halves
    weights, experts = moe_route(split_halves(h).float().sum(0) @ stacked["router"][i], k, norm)
    w = moe_dense_weights(weights, experts, E)
    bufs[0][i] += torch.bincount(experts.flatten(), minlength=E).to(bufs[0].device)
    bufs[1][t, i] = w
    gate, up = split_gate_up(_mm(h, stacked["ewgu"][i], stacked["egu_scale"][i]))
    a = (gelu_tanh(gate) * up).reshape(B, E, F) * w[:, :, None]
    wd = from_fragments(stacked["ewd"][i]).float().reshape(E, F, -1)
    return (torch.einsum("bef,efh->beh", a, wd) * stacked["ed_scale"][i][None]).sum(1)


def fused_stack_step_plain(t: int, x, stacked: dict, kc, vc, ks, vs, cos, sin, *,
                           num_heads: int, num_kv_heads: int, head_dim: int,
                           attn_scale: float, softcap: float, eps: float,
                           experts_per_token: int = 0, norm_topk_prob: bool = True,
                           graphs=None):
    """Plain version of `fused_stack_step` (same arguments and effects;
    `graphs` is taken and left unused: the result is a new tensor; the
    routing counter and log of a stack with experts are the eager calls')."""
    from vlm_bridge_tpu_torch.models.gemma2 import quantize_kv

    act = x.dtype
    L = stacked["wqkv"].shape[0]
    B = x.shape[0]
    NH, KH, D = num_heads, num_kv_heads, head_dim
    G, QHD, KHD = NH // KH, NH * head_dim, KH * head_dim
    mlp4 = "wgu4" in stacked
    moe = "router" in stacked
    bufs = (_moe_buffers(None, x.device, kc.shape[3], L, B, stacked["router"].shape[2])
            if moe else None)
    if moe:
        gu = gus = wd = ds = mm = None
    elif mlp4:
        gu, gus, wd, ds = (stacked[k] for k in ("wgu4", "gu_scale4", "wd4", "d_scale4"))
        mm, F = _mm4, 64 * wd.shape[2]
    else:
        gu, gus, wd, ds = (stacked[k] for k in ("wgu", "gu_scale", "wd", "d_scale"))
        mm, F = _mm, 32 * wd.shape[2]
    n = t + 1
    xf = x.float()
    for i in range(L):
        nl = stacked["norms"][i]
        h = _rms(xf, nl[0], eps)
        qkv = _mm(h, stacked["wqkv"][i], stacked["qkv_scale"][i])
        q = _rope(qkv[:, :QHD].reshape(B, KH, G, D), cos, sin)
        k = _rope(qkv[:, QHD:QHD + KHD].reshape(B, KH, D), cos, sin)
        v = qkv[:, QHD + KHD:].reshape(B, KH, D)
        kc[i, :, :, t], ks[i, :, :, t] = quantize_kv(k)
        vc[i, :, :, t], vs[i, :, :, t] = quantize_kv(v)
        lg = torch.einsum("bkgd,bknd->bkgn", q, kc[i, :, :, :n].float())
        lg = lg * ks[i, :, :, None, :n] * attn_scale
        lg = torch.tanh(lg / softcap) * softcap
        p = torch.softmax(lg, dim=-1) * vs[i, :, :, None, :n]
        attn = torch.einsum("bkgn,bknd->bkgd", p, vc[i, :, :, :n].float())
        o = _mm(attn.reshape(B, QHD), stacked["wo"][i], stacked["o_scale"][i])
        xf = xf + _rms(o, nl[1], eps)
        h = _rms(xf, nl[2], eps)
        if moe:
            y = _moe_mlp_plain(t, i, h, stacked, experts_per_token, norm_topk_prob, bufs)
        else:
            gate, up = split_gate_up(mm(h, gu[i], gus[i]))
            a = gelu_tanh(gate) * up
            y = mm(a, wd[i], ds[i])
        xf = xf + _rms(y, nl[3], eps)
    return xf.to(act)


def fused_stack_step(t: int, x, stacked: dict, kc, vc, ks, vs, cos, sin, *,
                     num_heads: int, num_kv_heads: int, head_dim: int,
                     attn_scale: float, softcap: float, eps: float,
                     experts_per_token: int = 0, norm_topk_prob: bool = True,
                     graphs: StepGraphs | None = None):
    """One lockstep decode step (position t) through all decoder layers.

    x: [B, H] scaled token embeddings; cos/sin: [head_dim] f32 RoPE rows of
    position t. Writes the new int8 K/V and scales of every layer into row
    t of kc/vc/ks/vs in place and returns the last layer's output [B, H]
    (before the final norm) in x.dtype. CUDA tensors run
    csrc/stack_step.cu (x bf16) or raise; CPU tensors run the plain version.
    A stacked dict with "wgu4" runs the int4 MLP stage (csrc/i4_gemm.cu); one
    with "router" the routed experts (experts_per_token of them a row, their
    weights renormalized where norm_topk_prob; `moe_counters`); one with none
    of "wgu", "wgu4" and "router" is refused. graphs (CUDA, x = graphs.x):
    the step runs from position t's graph (`StepGraphs`), captured on the
    first such call and replayed after; the output is then the graphs'
    buffer, overwritten by the next call.
    """
    kw = dict(num_heads=num_heads, num_kv_heads=num_kv_heads, head_dim=head_dim,
              attn_scale=attn_scale, softcap=softcap, eps=eps)
    mlp4 = "wgu4" in stacked
    moe = "router" in stacked
    if not mlp4 and not moe and "wgu" not in stacked:
        raise ValueError("stacked weights carry neither int8 (wgu) nor int4 (wgu4) MLP fields, "
                         "nor experts (router)")
    if moe:
        kw.update(experts_per_token=experts_per_token, norm_topk_prob=norm_topk_prob)
    if not x.is_cuda:
        return fused_stack_step_plain(t, x, stacked, kc, vc, ks, vs, cos, sin, **kw)
    sig = None
    if graphs is not None:
        sig = graphs.signature((x, kc, vc, ks, vs, cos, sin), stacked, num_heads, num_kv_heads,
                               head_dim, attn_scale, softcap, eps, experts_per_token,
                               bool(norm_topk_prob))
        out = graphs.replay(t, sig)
        if out is not None:
            fused_stack_step.launches += 1
            _STACK_STEP.replays += 1
            _STACK_STEP.moe_calls += moe
            return out
    B, H = x.shape
    L = stacked["wqkv"].shape[0]
    NQKV = 64 * stacked["wqkv"].shape[1]
    E = stacked["router"].shape[2] if moe else 0
    if moe:
        F = 32 * stacked["ewd"].shape[2] // E   # an expert's width
    else:
        F = (64 if mlp4 else 32) * stacked["wd4" if mlp4 else "wd"].shape[2]
    NH, KH, D = num_heads, num_kv_heads, head_dim
    QHD, KHD = NH * D, KH * D
    S = kc.shape[3]
    if not 0 <= t < S:
        raise ValueError(f"position {t} outside the {S}-row cache")
    if D not in (32, 64, 128, 256, 512) or NH % KH or NH // KH > stack_attn_heads(D):
        raise ValueError(f"unsupported head layout NH={NH} KH={KH} D={D}")
    if _stack_attn_bytes(NH // KH, D, t) > DG_STAGE_SMEM:
        raise ValueError(f"position {t}: {NH // KH} heads' logits over {t + 1} rows do not "
                         "fit the attention kernel's shared memory")
    for n in (NQKV, H, 2 * F):
        if n % 64:
            raise ValueError(f"projection width {n} must be a multiple of 64")
    if NQKV != QHD + 2 * KHD or H % 64 or QHD % 64 or F % 64:
        raise ValueError("stacked weight widths do not match the head layout")
    _check_row_width(H)
    c = cuda_lib.check
    c(x, "x", torch.bfloat16, (B, H))
    if moe:
        if not 0 < experts_per_token <= E or E > MOE_MAX_EXPERTS or E % 4 or F % 64:
            raise ValueError(f"{experts_per_token} of {E} experts of width {F}: the routing "
                             f"takes k <= E <= {MOE_MAX_EXPERTS}, E a multiple of 4, the "
                             "products experts of a multiple of 64")
        group = None
        mlp = (("ewgu", (L, *frag_shape(H, 2 * E * F)), torch.int8),
               ("egu_scale", (L, 2 * E * F), torch.float32),
               ("ewd", (L, *frag_shape(E * F, H)), torch.int8),
               ("ed_scale", (L, E, H), torch.float32))
        c(stacked["router"], "router", torch.float32, (L, H, E))
    elif mlp4:
        group = _mlp4_group(stacked, H)
        if group is not None and (group % 32 or H % group or F % group):
            raise ValueError(f"int4 scale group {group} must be a multiple of 32 that divides "
                             f"H={H} and F={F}")
        mlp = (("wgu4", (L, *frag4_shape(H, 2 * F)), torch.int8),
               ("gu_scale4", (L, H // (group or H), 2 * F), torch.float32),
               ("wd4", (L, *frag4_shape(F, H)), torch.int8),
               ("d_scale4", (L, F // (group or F), H), torch.float32))
    else:
        group = None
        mlp = (("wgu", (L, *frag_shape(H, 2 * F)), torch.int8),
               ("gu_scale", (L, 2 * F), torch.float32),
               ("wd", (L, *frag_shape(F, H)), torch.int8), ("d_scale", (L, H), torch.float32))
    for name, shape, dt in (
            ("wqkv", (L, *frag_shape(H, NQKV)), torch.int8),
            ("qkv_scale", (L, NQKV), torch.float32),
            ("wo", (L, *frag_shape(QHD, H)), torch.int8), ("o_scale", (L, H), torch.float32),
            *mlp, ("norms", (L, 4, H), torch.float32)):
        c(stacked[name], name, dt, shape)
    for name, tt, dt, shape in (("kc", kc, torch.int8, (L, B, KH, S, D)),
                                ("vc", vc, torch.int8, (L, B, KH, S, D)),
                                ("ks", ks, torch.float32, (L, B, KH, S)),
                                ("vs", vs, torch.float32, (L, B, KH, S)),
                                ("cos", cos, torch.float32, (D,)),
                                ("sin", sin, torch.float32, (D,))):
        c(tt, name, dt, shape)
    dev = x.device
    new = _step_buffers(graphs, dev)
    x_out = new("x_out", (B, H), torch.bfloat16)
    x32 = new("x32", (B, H), torch.float32)
    hbuf = new("hbuf", (2, B, H), torch.bfloat16)  # split hi | lo
    abuf = new("abuf", (2, B, max(QHD, F)), torch.bfloat16)
    shapes = [(B, NQKV, H), (B, H, QHD)]
    shapes += [(B, 2 * E * F, H), (B, H, E * F)] if moe else [(B, 2 * F, H), (B, H, F)]
    ws, slots, counters = _workspace(dev, shapes) if graphs is None else graphs.workspace(shapes)
    s = stacked
    p = cuda_lib.ptr
    route = ()
    if moe:
        # the routing's logits, weights and per-row arrival counts (zero between
        # launches), the counter and the log, and the experts' hidden [2, B, E F]; held
        # here until the call has been queued
        route = (s["router"], new("route_logits", (B, E), torch.float32),
                 new("route_w", (B, E), torch.float32),
                 (graphs.buffer if graphs is not None else partial(_scratch, dev))(
                     "route_arrive", (B,), torch.int32, zero=True),
                 *_moe_buffers(graphs, dev, S, L, B, E),
                 new("ebuf", (2, B, E * F), torch.bfloat16))
    _run_step(graphs, t, sig, _STACK_STEP, "vbt_fused_stack_step", (
        p(x), p(x_out),
        p(s["wqkv"]), p(s["qkv_scale"]), p(s["wo"]), p(s["o_scale"]),
        *(p(s[name]) for name, _, _ in mlp), p(s["norms"]),
        p(cos), p(sin), p(kc), p(vc), p(ks), p(vs),
        p(x32), p(hbuf), p(abuf), p(ws), slots, counters,
        L, B, H, NH, KH, D, F, S, int(t), int(mlp4), group or 0,
        float(attn_scale), float(softcap), float(eps),
        *(map(p, route) if moe else (0,) * 7), E, int(experts_per_token) if moe else 0,
        int(bool(norm_topk_prob))), x_out)
    fused_stack_step.launches += 1
    if moe:
        _STACK_STEP.moe_calls += 1
    return x_out


# calls that ran the step's kernels; of those with graphs, the ones that
# captured a position's graph and the ones that replayed it. The graph
# counters are kept on this function object (_STACK_STEP) also while a caller
# has wrapped the module attribute.
fused_stack_step.launches = fused_stack_step.captures = fused_stack_step.replays = 0
# of the calls that ran the kernels (replays included), those of a stack with experts
fused_stack_step.moe_calls = 0
_STACK_STEP = fused_stack_step

MOE_MAX_EXPERTS = 256   # csrc/stack_step.cu: the routing kernel's experts a row


# ---------------------------------------------------------------------------
# Whole bridge
# ---------------------------------------------------------------------------


def fused_bridge_step_plain(t: int, x, bst: dict, ck, cks, cv, cvs, sk, sv, *,
                            num_heads_cross: int, num_heads_self: int, eps: float, graphs=None):
    """Plain version of `fused_bridge_step` (same arguments and effects;
    `graphs` is taken and left unused)."""
    act = x.dtype
    nb = bst["wq"].shape[0]
    B, ld = x.shape
    Hc, Hs = num_heads_cross, num_heads_self
    Dc, Ds = ld // Hc, ld // Hs
    n = t + 1
    xf = x.float()
    for k in range(nb):
        ln = bst["lns"][k]
        h = _ln(xf, ln[0], ln[1], eps)
        q = (_mm(h, bst["wq"][k], bst["q_scale"][k]) + bst["q_bias"][k]).reshape(B, Hc, Dc)
        lg = torch.einsum("bhd,bhsd->bhs", q, ck[k].float()) * Dc ** -0.5 * cks[k]
        p = torch.softmax(lg, dim=-1) * cvs[k]
        o = torch.einsum("bhs,bhsd->bhd", p, cv[k].float()).reshape(B, ld)
        xf = xf + _mm(o, bst["wo_c"][k], bst["o_c_scale"][k]) + bst["o_c_bias"][k]

        h = _ln(xf, ln[2], ln[3], eps)
        qkv = _mm(h, bst["wqkv"][k], bst["qkv_scale"][k]) + bst["qkv_bias"][k]
        q = qkv[:, :ld].reshape(B, Hs, Ds)
        sk[k, :, :, t] = qkv[:, ld:2 * ld].reshape(B, Hs, Ds).to(sk.dtype)
        sv[k, :, :, t] = qkv[:, 2 * ld:].reshape(B, Hs, Ds).to(sv.dtype)
        lg = torch.einsum("bhd,bhnd->bhn", q, sk[k, :, :, :n].float()) * Ds ** -0.5
        p = torch.softmax(lg, dim=-1)
        o = torch.einsum("bhn,bhnd->bhd", p, sv[k, :, :, :n].float()).reshape(B, ld)
        xf = xf + _mm(o, bst["wo_s"][k], bst["o_s_scale"][k]) + bst["o_s_bias"][k]

        h = _ln(xf, ln[4], ln[5], eps)
        g = _mm(h, bst["fc1"][k], bst["fc1_scale"][k]) + bst["fc1_bias"][k]
        a = gelu_exact(g)
        xf = xf + _mm(a, bst["fc2"][k], bst["fc2_scale"][k]) + bst["fc2_bias"][k]
    return xf.to(act)


# stacked bridge weight -> prefix of its scale/bias entries
_BRIDGE_PREFIX = {"wq": "q", "wo_c": "o_c", "wqkv": "qkv", "wo_s": "o_s",
                  "fc1": "fc1", "fc2": "fc2"}


def fused_bridge_step(t: int, x, bst: dict, ck, cks, cv, cvs, sk, sv, *,
                      num_heads_cross: int, num_heads_self: int, eps: float,
                      graphs: StepGraphs | None = None):
    """One decode step (position t) through both bridge blocks.

    x: [B, ld] token embeddings. Writes the new self-attention K/V (rounded
    to the cache dtype) into row t of sk/sv in place and returns the bridge
    output [B, ld] in x.dtype. CUDA tensors run csrc/bridge_step.cu (x and
    the self caches bf16) or raise; CPU tensors run the plain version.
    graphs: as in `fused_stack_step`.
    """
    kw = dict(num_heads_cross=num_heads_cross, num_heads_self=num_heads_self, eps=eps)
    if not x.is_cuda:
        return fused_bridge_step_plain(t, x, bst, ck, cks, cv, cvs, sk, sv, **kw)
    sig = None
    if graphs is not None:
        sig = graphs.signature((x, ck, cks, cv, cvs, sk, sv), bst, num_heads_cross,
                               num_heads_self, eps)
        out = graphs.replay(t, sig)
        if out is not None:
            fused_bridge_step.launches += 1
            _BRIDGE_STEP.replays += 1
            return out
    B, ld = x.shape
    nb = bst["wq"].shape[0]
    F = 64 * bst["fc1"].shape[1]
    Hc, Hs = num_heads_cross, num_heads_self
    Dc, Ds = ld // Hc, ld // Hs
    Sv, Smax = ck.shape[3], sk.shape[3]
    if not 0 <= t < Smax:
        raise ValueError(f"position {t} outside the {Smax}-row self cache")
    if (Dc * Hc != ld or Ds * Hs != ld or Dc % 32 or Dc > 1024 or Ds not in (32, 64, 128, 256)
            or _cross_attn_bytes(Dc, Sv) > DG_STAGE_SMEM):
        raise ValueError(f"unsupported head widths Dc={Dc} Ds={Ds} (cross rows {Sv})")
    if 4 * (Ds + t + 1) * 4 > DG_STAGE_SMEM:
        raise ValueError(f"position {t}: the self attention's logits do not fit the stage's "
                         "shared memory")
    if ld % 64 or F % 64:
        raise ValueError(f"widths ld={ld} F={F} must be multiples of 64")
    _check_row_width(ld)
    c = cuda_lib.check
    c(x, "x", torch.bfloat16, (B, ld))
    c(bst["lns"], "lns", torch.float32, (nb, 6, ld))
    shapes = {"wq": (ld, ld), "wo_c": (ld, ld), "wqkv": (ld, 3 * ld),
              "wo_s": (ld, ld), "fc1": (ld, F), "fc2": (F, ld)}
    for name, prefix in _BRIDGE_PREFIX.items():
        kin, nout = shapes[name]
        c(bst[name], name, torch.int8, (nb, *frag_shape(kin, nout)))
        for part in ("scale", "bias"):
            key = f"{prefix}_{part}"
            c(bst[key], key, torch.float32, (nb, nout))
    c(ck, "ck", torch.int8, (nb, B, Hc, Sv, Dc))
    c(cv, "cv", torch.int8, (nb, B, Hc, Sv, Dc))
    c(cks, "cks", torch.float32, (nb, B, Hc, Sv))
    c(cvs, "cvs", torch.float32, (nb, B, Hc, Sv))
    c(sk, "sk", torch.bfloat16, (nb, B, Hs, Smax, Ds))
    c(sv, "sv", torch.bfloat16, (nb, B, Hs, Smax, Ds))
    dev = x.device
    new = _step_buffers(graphs, dev)
    x_out = new("x_out", (B, ld), torch.bfloat16)
    x32 = new("x32", (B, ld), torch.float32)
    hbuf = new("hbuf", (2, B, ld), torch.bfloat16)  # split hi | lo
    abuf = new("abuf", (2, B, max(ld, F)), torch.bfloat16)
    shapes = [(B, ld, ld), (B, 3 * ld, ld), (B, F, ld), (B, ld, F)]
    ws, slots, counters = _workspace(dev, shapes) if graphs is None else graphs.workspace(shapes)
    s = bst
    p = cuda_lib.ptr
    _run_step(graphs, t, sig, _BRIDGE_STEP, "vbt_fused_bridge_step", (
        p(x), p(x_out), p(s["lns"]),
        p(s["wq"]), p(s["q_scale"]), p(s["q_bias"]),
        p(ck), p(cks), p(cv), p(cvs),
        p(s["wo_c"]), p(s["o_c_scale"]), p(s["o_c_bias"]),
        p(s["wqkv"]), p(s["qkv_scale"]), p(s["qkv_bias"]),
        p(sk), p(sv),
        p(s["wo_s"]), p(s["o_s_scale"]), p(s["o_s_bias"]),
        p(s["fc1"]), p(s["fc1_scale"]), p(s["fc1_bias"]),
        p(s["fc2"]), p(s["fc2_scale"]), p(s["fc2_bias"]),
        p(x32), p(hbuf), p(abuf), p(ws), slots, counters,
        nb, B, ld, Hc, Hs, Sv, Smax, F, int(t), float(eps)), x_out)
    fused_bridge_step.launches += 1
    return x_out


# as for fused_stack_step
fused_bridge_step.launches = fused_bridge_step.captures = fused_bridge_step.replays = 0
_BRIDGE_STEP = fused_bridge_step


# ---------------------------------------------------------------------------
# One decoder layer in two calls
# ---------------------------------------------------------------------------


def layer_fragments(lp: dict) -> dict:
    """One int8 decoder layer's params with the forms the CUDA per-layer steps
    read added to its dicts: "w_frag" (`to_fragments` of "w_int8") on
    attn.qkv, attn.o and mlp.down, and on mlp.gate the gate|up product's
    "gu_frag" / "gu_scale", gate and up columns (and scales) interleaved in
    runs of GU_RUN (`interleave_gate_up`). The int8 weights and scales stay
    (the plain versions and the other int8 paths read them); the dicts are
    new, their tensors shared. 77.8 MB more a Gemma-2-2B layer."""
    attn, mlp = lp["attn"], lp["mlp"]
    gate, up = mlp["gate"], mlp["up"]

    def frag(wq):
        return {**wq, "w_frag": to_fragments(wq["w_int8"])}

    gu = to_fragments(interleave_gate_up(gate["w_int8"], up["w_int8"]))
    return {**lp, "attn": {**attn, "qkv": frag(attn["qkv"]), "o": frag(attn["o"])},
            "mlp": {**mlp, "down": frag(mlp["down"]),
                    "gate": {**gate, "gu_frag": gu,
                             "gu_scale": interleave_gate_up(gate["scale"], up["scale"])}}}


def _bf16(v: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and return to f32: where the kernels cast."""
    return v.to(torch.bfloat16).float()


def _mmq(a: torch.Tensor, wq: dict) -> torch.Tensor:
    """f32 (a @ w_int8) * scale over a row-major int8 dict."""
    return (a @ wq["w_int8"].float()) * wq["scale"]


def fused_attn_step_plain(t: int, x, wqkv: dict, wo: dict, in_norm, post_norm, cos, sin,
                          kc, vc, ks, vs, *, num_heads: int, num_kv_heads: int, head_dim: int,
                          attn_scale: float, softcap: float, eps: float):
    """Plain version of `fused_attn_step` (same arguments and results)."""
    from vlm_bridge_tpu_torch.models.gemma2 import quantize_kv

    B = x.shape[0]
    NH, KH, D = num_heads, num_kv_heads, head_dim
    G, QHD, KHD = NH // KH, NH * D, KH * D
    xf = x.float()
    qkv = _mmq(_bf16(_rms(xf, in_norm.float(), eps)), wqkv)
    q = _rope(qkv[:, :QHD].reshape(B, KH, G, D), cos, sin)
    k = _rope(qkv[:, QHD:QHD + KHD].reshape(B, KH, D), cos, sin)
    v = qkv[:, QHD + KHD:].reshape(B, KH, D)
    k_i8, k_sc = quantize_kv(k)
    v_i8, v_sc = quantize_kv(v)
    # the new row attends through its quantized value, as a cache row would
    k_q, v_q = k_i8.float() * k_sc[..., None], v_i8.float() * v_sc[..., None]
    ls = (q * k_q[:, :, None]).sum(-1, keepdim=True) * attn_scale            # [B, KH, G, 1]
    ls = torch.tanh(ls / softcap) * softcap
    # history rows s < t only: whatever the cache holds at and beyond t is never read
    lg = torch.einsum("bkgd,bksd->bkgs", _bf16(q), kc[:, :, :t].float())
    lg = lg * ks[:, :, None, :t] * attn_scale
    lg = torch.tanh(lg / softcap) * softcap
    m = torch.maximum(lg.amax(dim=-1, keepdim=True), ls) if t > 0 else ls
    e_hist, e_self = torch.exp(lg - m), torch.exp(ls - m)
    denom = e_hist.sum(dim=-1, keepdim=True) + e_self
    p = _bf16(e_hist / denom * vs[:, :, None, :t])
    out = torch.einsum("bkgs,bksd->bkgd", p, vc[:, :, :t].float())
    out = out + (e_self / denom) * v_q[:, :, None]
    proj = _mmq(_bf16(out.reshape(B, QHD)), wo)
    x_out = (xf + _rms(proj, post_norm.float(), eps)).to(x.dtype)
    return (x_out, k_i8.reshape(B, KHD), v_i8.reshape(B, KHD), k_sc.T.contiguous(),
            v_sc.T.contiguous())


def _frag_of(wq: dict, key: str, name: str) -> torch.Tensor:
    """The fragment form `key` of an int8 dict, which the CUDA per-layer steps
    read; raises where the weights were not prepared."""
    if key not in wq:
        raise ValueError(
            f"{name}: the int8 dict carries no fragment form ({key!r}), which the CUDA "
            "per-layer steps read: prepare the model's weights once with "
            "vlm_bridge_tpu_torch.tools.loading.prepare_fused_layers (decode_kernels."
            "layer_fragments for one layer)")
    return wq[key]


def fused_attn_step(t: int, x, wqkv: dict, wo: dict, in_norm, post_norm, cos, sin,
                    kc, vc, ks, vs, *, num_heads: int, num_kv_heads: int, head_dim: int,
                    attn_scale: float, softcap: float, eps: float):
    """One decoder layer's attention half for one lockstep decode step.

    x: [B, H] residual stream; t: the position (cache rows s < t are valid);
    wqkv / wo: the layer's fused q|k|v and o int8 dicts; in_norm / post_norm:
    [H]; cos / sin: [head_dim] f32 RoPE rows of position t; kc / vc:
    [B, KH, S, D] int8 with scales ks / vs [B, KH, S] f32 (this port's layout;
    read, never written). Returns (x_out [B, H] in x.dtype, k_new [B, KH*D]
    int8, v_new, k_scale [KH, B] f32, v_scale): the caller writes the new
    entries at row t. CUDA tensors run csrc/layer_step.cu (x and the norm
    weights bf16, as the model holds them on the card; the dicts with their
    fragment forms, `layer_fragments`) or raise; CPU tensors run the plain
    version."""
    kw = dict(num_heads=num_heads, num_kv_heads=num_kv_heads, head_dim=head_dim,
              attn_scale=attn_scale, softcap=softcap, eps=eps)
    if not x.is_cuda:
        return fused_attn_step_plain(t, x, wqkv, wo, in_norm, post_norm, cos, sin,
                                     kc, vc, ks, vs, **kw)
    B, H = x.shape
    NH, KH, D = num_heads, num_kv_heads, head_dim
    QHD, KHD = NH * D, KH * D
    NQKV = QHD + 2 * KHD
    S = kc.shape[2]
    if not 0 <= t < S:
        raise ValueError(f"position {t} outside the {S}-row cache")
    if D % 32 or D > 1024 or NH % KH or NH // KH > D // 32:
        raise ValueError(f"unsupported head layout NH={NH} KH={KH} D={D}")
    if _layer_attn_bytes(NH // KH, D, t) > DG_STAGE_SMEM:
        raise ValueError(f"position {t}: {NH // KH} heads' logits over {t} rows do not fit the "
                         "attention kernel's shared memory")
    if H % 64 or QHD % 64:
        raise ValueError(f"unsupported widths H={H} q={QHD}: the products take multiples of 64")
    _check_row_width(H)
    c = cuda_lib.check
    c(x, "x", torch.bfloat16, (B, H))
    for name, tt, dt, shape in (("in_norm", in_norm, torch.bfloat16, (H,)),
                                ("post_norm", post_norm, torch.bfloat16, (H,)),
                                ("cos", cos, torch.float32, (D,)),
                                ("sin", sin, torch.float32, (D,)),
                                ("kc", kc, torch.int8, (B, KH, S, D)),
                                ("vc", vc, torch.int8, (B, KH, S, D)),
                                ("ks", ks, torch.float32, (B, KH, S)),
                                ("vs", vs, torch.float32, (B, KH, S))):
        c(tt, name, dt, shape)
    frags = []
    for name, wq, (K, N) in (("wqkv", wqkv, (H, NQKV)), ("wo", wo, (QHD, H))):
        frags.append(_frag_of(wq, "w_frag", name))
        c(frags[-1], f"{name}.w_frag", torch.int8, frag_shape(K, N))
        c(wq["scale"], f"{name}.scale", torch.float32, (N,))
    dev = x.device
    ws, slots, counters = _workspace(dev, [(B, NQKV, H), (B, H, QHD)])
    h = _scratch(dev, "h", (B, H), torch.bfloat16)
    attn = _scratch(dev, "attn", (B, QHD), torch.bfloat16)
    x_out = torch.empty(B, H, dtype=torch.bfloat16, device=dev)
    k_new = torch.empty(B, KHD, dtype=torch.int8, device=dev)
    v_new = torch.empty(B, KHD, dtype=torch.int8, device=dev)
    k_sc = torch.empty(KH, B, dtype=torch.float32, device=dev)
    v_sc = torch.empty(KH, B, dtype=torch.float32, device=dev)
    p = cuda_lib.ptr
    cuda_lib.call(
        "vbt_fused_attn_step", p(x), p(frags[0]), p(wqkv["scale"]), p(frags[1]),
        p(wo["scale"]), p(in_norm), p(post_norm), p(cos), p(sin), p(kc), p(vc), p(ks), p(vs),
        p(x_out), p(k_new), p(v_new), p(k_sc), p(v_sc), p(h), p(attn), p(ws), slots, counters,
        B, H, NH, KH, D, S, int(t), float(attn_scale), float(softcap), float(eps))
    fused_attn_step.launches += 1
    return x_out, k_new, v_new, k_sc, v_sc


fused_attn_step.launches = 0


def fused_mlp_step_plain(x, gate_q: dict, up_q: dict, down_q: dict, pre_norm, post_norm, *,
                         eps: float):
    """Plain version of `fused_mlp_step` (same arguments and result)."""
    xf = x.float()
    h = _bf16(_rms(xf, pre_norm.float(), eps))
    hidden = _bf16(gelu_tanh(_mmq(h, gate_q)) * _mmq(h, up_q))
    return (xf + _rms(_mmq(hidden, down_q), post_norm.float(), eps)).to(x.dtype)


def fused_mlp_step(x, gate_q: dict, up_q: dict, down_q: dict, pre_norm, post_norm, *,
                   eps: float):
    """x + rms_post(down(gelu_tanh(gate(h)) * up(h))), h = rms_pre(x), for one
    decoder layer: h and the hidden rounded to bf16 before their products,
    f32 accumulation, scales applied after the sums, one rounding to x.dtype.
    x: [M, H]; gate / up: int8 dicts [H, F]; down: [F, H]; norms [H]. The JAX
    function's `block_f` is Mosaic's tile and has no counterpart: the order in
    which the kernel adds over F is its own and fixed. CUDA tensors run
    csrc/layer_step.cu (x and the norm weights bf16; the gate dict with the
    interleaved gate|up fragments and the down dict with its fragments,
    `layer_fragments`) or raise; CPU tensors run the plain version."""
    if not x.is_cuda:
        return fused_mlp_step_plain(x, gate_q, up_q, down_q, pre_norm, post_norm, eps=eps)
    M, H = x.shape
    F = gate_q["scale"].shape[0]
    if H % 64 or F % 64:
        raise ValueError(f"unsupported widths H={H} F={F}: the products take multiples of 64")
    _check_row_width(H)
    c = cuda_lib.check
    c(x, "x", torch.bfloat16, (M, H))
    c(pre_norm, "pre_norm", torch.bfloat16, (H,))
    c(post_norm, "post_norm", torch.bfloat16, (H,))
    wgu, wd = _frag_of(gate_q, "gu_frag", "gate"), _frag_of(down_q, "w_frag", "down")
    gus = _frag_of(gate_q, "gu_scale", "gate")
    c(wgu, "gate.gu_frag", torch.int8, frag_shape(H, 2 * F))
    c(gus, "gate.gu_scale", torch.float32, (2 * F,))
    c(wd, "down.w_frag", torch.int8, frag_shape(F, H))
    c(down_q["scale"], "down.scale", torch.float32, (H,))
    dev = x.device
    ws, slots, counters = _workspace(dev, [(M, 2 * F, H), (M, H, F)])
    h = _scratch(dev, "h", (M, H), torch.bfloat16)
    hidden = _scratch(dev, "hidden", (M, F), torch.bfloat16)
    x_out = torch.empty(M, H, dtype=torch.bfloat16, device=dev)
    p = cuda_lib.ptr
    cuda_lib.call(
        "vbt_fused_mlp_step", p(x), p(wgu), p(gus), p(wd), p(down_q["scale"]), p(pre_norm),
        p(post_norm), p(x_out), p(h), p(hidden), p(ws), slots, counters, M, H, F, float(eps))
    fused_mlp_step.launches += 1
    return x_out


fused_mlp_step.launches = 0
