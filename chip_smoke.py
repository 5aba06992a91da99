"""Run the PyTorch port's int8 greedy caption-serving path once on one GPU.

    python3 chip_smoke.py

1. Refuses to run without CUDA; prints the card's name and power limit.
2. Builds the CUDA kernels from vlm_bridge_tpu_torch/csrc (nvcc, sm_90a).
3. One phase per kernel: the kernel and its plain PyTorch version at the
   main path's shapes on the same seeded inputs, their max abs error
   against the stated tolerance, and both times.
4. The main path: VLMConfig.default() at full width, seeded random weights
   made on the device, --quantize embedding,mlp,attn,bridge with the int8
   KV cache; 64 seeded uint8 images -> normalize_on_device ->
   generate_tokens (greedy, 50 tokens, no early stop). Checks that every
   kernel ran on every step, that the ids and lengths are well formed, and
   that each row's first token equals the plain path's on the card.
5. Prints a JSON line of per-kernel results, then, as the last line,
   {"ok": true, "device": {...}}. Any failure raises (exit code != 0).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

SEED = 0
BATCH = 64
NEW_TOKENS = 50
HIDDEN_TOL = 3e-2  # x max|ref|: the bf16/int8 noise the JAX kernel tests allow


def card_line() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return res.stdout.strip().splitlines()[0] if res.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown (nvidia-smi unavailable)"


def time_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` runs after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_close(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    err = float((got.float() - want.float()).abs().max())
    tol = HIDDEN_TOL * float(want.float().abs().max())
    print(f"[{name}] max_abs_err={err:.6g} tol={tol:.6g}")
    if not err <= tol:
        raise AssertionError(f"{name}: max abs error {err} above {tol}")
    return err


def phase_argmax_head(params, dev, gen):
    from vlm_bridge_tpu_torch.ops import quant

    E = params["lm"]["embedding"]
    V, H = E["w_int8"].shape
    x = (torch.randn(BATCH, H, generator=gen, device=dev)).to(torch.bfloat16)
    # planted tie: vocab rows 1000 and 200000 (different blocks) equal and,
    # aligned with row 5, the winners; row 7 all NaN -> id 0
    table = {"w_int8": E["w_int8"].clone(), "scale": E["scale"].clone()}
    row = (torch.sign(x[5].float()) * 127).to(torch.int8)
    for v in (1000, 200000):
        table["w_int8"][v] = row
        table["scale"][v] = 0.05
    x[7] = float("nan")
    got = quant.int8_matmul_t_argmax(x, table)
    want = quant.int8_matmul_t_argmax_plain(x, table)
    torch.cuda.synchronize()
    mism = int((got != want).sum())
    print(f"[int8_matmul_t_argmax] ids differing={mism} (tolerance 0); "
          f"tie row -> {int(got[5])}, NaN row -> {int(got[7])}")
    if mism or int(got[5]) != 1000 or int(got[7]) != 0:
        raise AssertionError("argmax head disagrees with its plain version")
    ms = time_ms(lambda: quant.int8_matmul_t_argmax(x, table), 20)
    plain_ms = time_ms(lambda: quant.int8_matmul_t_argmax_plain(x, table), 3)
    print(f"[int8_matmul_t_argmax] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms}


def phase_stack(params, cfg, dev, gen, t=20):
    from vlm_bridge_tpu_torch.models import gemma2
    from vlm_bridge_tpu_torch.ops import decode_kernels as dk
    from vlm_bridge_tpu_torch.ops.layers import rope_table

    lm = cfg.lm
    stacked = params["lm"]["stacked_decode"]
    S = gemma2.fused_cache_rows(NEW_TOKENS + 1)
    cache = gemma2.StackedKVCache.zeros(lm, BATCH, NEW_TOKENS + 1, device=dev)
    # history rows 0..t-1: random int8 codes with realistic per-vector scales
    cache.k[:, :, :, :t] = torch.randint(-127, 128, cache.k[:, :, :, :t].shape, generator=gen,
                                         device=dev, dtype=torch.int8)
    cache.v[:, :, :, :t] = torch.randint(-127, 128, cache.v[:, :, :, :t].shape, generator=gen,
                                         device=dev, dtype=torch.int8)
    cache.k_scale[..., :t] = 0.02 + 0.01 * torch.rand(cache.k_scale[..., :t].shape,
                                                      generator=gen, device=dev)
    cache.v_scale[..., :t] = 0.02 + 0.01 * torch.rand(cache.v_scale[..., :t].shape,
                                                      generator=gen, device=dev)
    x = (torch.randn(BATCH, lm.hidden_size, generator=gen, device=dev) * 0.02
         * lm.hidden_size ** 0.5).to(torch.bfloat16)
    cos, sin = rope_table(torch.tensor([t], device=dev), lm.head_dim, lm.rope_theta)
    cos, sin = cos[0].contiguous(), sin[0].contiguous()
    kw = dict(num_heads=lm.num_heads, num_kv_heads=lm.num_kv_heads, head_dim=lm.head_dim,
              attn_scale=lm.attn_scale, softcap=lm.attn_logit_softcap, eps=lm.rms_norm_eps)
    ck = [c.clone() for c in cache]
    cp = [c.clone() for c in cache]
    got = dk.fused_stack_step(t, x, stacked, *ck, cos, sin, **kw)
    want = dk.fused_stack_step_plain(t, x, stacked, *cp, cos, sin, **kw)
    torch.cuda.synchronize()
    err = check_close("fused_stack_step", got, want)
    codes = (ck[0][:, :, :, t].int() - cp[0][:, :, :, t].int()).abs()
    share = float((codes <= 1).float().mean())
    print(f"[fused_stack_step] new K codes within 1: {share:.6f} (need >= 0.99)")
    if share < 0.99:
        raise AssertionError("stack step K cache row disagrees")
    ms = time_ms(lambda: dk.fused_stack_step(t, x, stacked, *ck, cos, sin, **kw), 10)
    plain_ms = time_ms(lambda: dk.fused_stack_step_plain(t, x, stacked, *cp, cos, sin, **kw), 3)
    print(f"[fused_stack_step] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (S={S}, t={t})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_bridge(params, cfg, dev, gen, t=20):
    from vlm_bridge_tpu_torch.inference.generate import _build_cross_cache
    from vlm_bridge_tpu_torch.models import bridge
    from vlm_bridge_tpu_torch.ops import decode_kernels as dk

    bc = cfg.bridge
    bp = params["bridge"]
    bst = bridge.stack_bridge_decode_params(bp, bc)
    vision = torch.randn(BATCH, cfg.num_vision_tokens, bc.vision_dim, generator=gen,
                         device=dev).to(torch.bfloat16)
    cache = _build_cross_cache(bp, bc, vision, NEW_TOKENS + 1, torch.bfloat16, kv_quant=True)
    cache.self_k[:, :, :, :t] = torch.randn(cache.self_k[:, :, :, :t].shape, generator=gen,
                                            device=dev).to(torch.bfloat16)
    cache.self_v[:, :, :, :t] = torch.randn(cache.self_v[:, :, :, :t].shape, generator=gen,
                                            device=dev).to(torch.bfloat16)
    x = (torch.randn(BATCH, bc.language_dim, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    kw = dict(num_heads_cross=bc.num_heads_cross, num_heads_self=bc.num_heads_self,
              eps=bc.layer_norm_eps)
    cross = (cache.cross_k, cache.cross_k_scale, cache.cross_v, cache.cross_v_scale)
    sk, sv = cache.self_k.clone(), cache.self_v.clone()
    pk, pv = cache.self_k.clone(), cache.self_v.clone()
    got = dk.fused_bridge_step(t, x, bst, *cross, sk, sv, **kw)
    want = dk.fused_bridge_step_plain(t, x, bst, *cross, pk, pv, **kw)
    torch.cuda.synchronize()
    err = check_close("fused_bridge_step", got, want)
    check_close("fused_bridge_step self K row t", sk[:, :, :, t], pk[:, :, :, t])
    ms = time_ms(lambda: dk.fused_bridge_step(t, x, bst, *cross, sk, sv, **kw), 10)
    plain_ms = time_ms(lambda: dk.fused_bridge_step_plain(t, x, bst, *cross, pk, pv, **kw), 3)
    print(f"[fused_bridge_step] kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script runs on a GPU only",
              file=sys.stderr)
        return 2
    card = card_line()
    print(f"card (name, power limit): {card}", flush=True)

    from vlm_bridge_tpu.configs import VLMConfig
    from vlm_bridge_tpu_torch.data.preprocess import normalize_on_device
    from vlm_bridge_tpu_torch.inference.generate import (
        GenerationConfig, _eos_lengths, generate_tokens)
    from vlm_bridge_tpu_torch.models import bridge, full_model, gemma2
    from vlm_bridge_tpu_torch.ops import cuda_lib, decode_kernels, quant
    from vlm_bridge_tpu_torch.tools.loading import prestack_decode_params

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain references run full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    cuda_lib.lib()
    print(f"kernel build+load: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {'ran' if cuda_lib.build_seconds is not None else 'not needed'})", flush=True)

    # full-width model, seeded on the device, int8 serving recipe
    t0 = time.perf_counter()
    cfg = VLMConfig.default()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    with torch.no_grad():
        params = full_model.init(cfg, generator=gen, device=dev)
        params["lm"] = gemma2.quantize_params(params["lm"], ("embedding", "mlp", "attn"))
        params["bridge"] = bridge.quantize_decode_params(params["bridge"])
    gcfg = GenerationConfig(max_length=NEW_TOKENS, greedy=True, kv_quant=True, early_stop=False)
    params = prestack_decode_params(params, cfg, gcfg)
    if "stacked_decode" not in params["lm"]:
        raise AssertionError("the int8 stack decode does not serve VLMConfig.default()")
    torch.cuda.synchronize()
    print(f"init + quantize + stack: {time.perf_counter() - t0:.1f} s; "
          f"allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)

    results = {}
    with torch.no_grad():
        results["int8_matmul_t_argmax"] = phase_argmax_head(params, dev, gen)
        results["fused_stack_step"] = phase_stack(params, cfg, dev, gen)
        results["fused_bridge_step"] = phase_bridge(params, cfg, dev, gen)

    pix_gen = torch.Generator(device=dev)
    pix_gen.manual_seed(SEED + 1)
    pixels_u8 = torch.randint(0, 256, (BATCH, cfg.image_size, cfg.image_size, 3),
                              generator=pix_gen, device=dev, dtype=torch.uint8)
    pixels = normalize_on_device(pixels_u8, dtype=torch.bfloat16)
    # warm-up (cuBLAS handles, allocator) on 2 tokens, then the counted run
    generate_tokens(params, cfg, pixel_values=pixels,
                    gen=GenerationConfig(max_length=2, greedy=True, kv_quant=True))
    torch.cuda.synchronize()
    counters = (decode_kernels.fused_stack_step, decode_kernels.fused_bridge_step,
                quant.int8_matmul_t_argmax)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    toks, lens = generate_tokens(params, cfg, pixel_values=pixels, gen=gcfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"main path launches: {launches}")
    for name, n in launches.items():
        if n != NEW_TOKENS:
            raise AssertionError(f"{name} launched {n} times, expected {NEW_TOKENS}")

    toks_c, lens_c = toks.cpu(), lens.cpu()
    if tuple(toks_c.shape) != (BATCH, NEW_TOKENS + 1):
        raise AssertionError(f"tokens shape {tuple(toks_c.shape)}")
    if not ((toks_c >= 0) & (toks_c < cfg.lm.vocab_size)).all():
        raise AssertionError("token ids out of range")
    if not (toks_c[:, 0] == cfg.lm.bos_token_id).all():
        raise AssertionError("first column is not BOS")
    if not torch.equal(lens_c, _eos_lengths(toks_c, cfg.lm.eos_token_id)):
        raise AssertionError("lengths disagree with the first EOS")
    print(f"main path: {BATCH} captions x {NEW_TOKENS} tokens in {dt:.3f} s = "
          f"{BATCH / dt:.2f} captions/s (encode + decode) on {card}")

    t0 = time.perf_counter()
    ref, _ = generate_tokens(params, cfg, pixel_values=pixels,
                             gen=GenerationConfig(max_length=NEW_TOKENS, greedy=True,
                                                  kv_quant=True, force_plain=True))
    torch.cuda.synchronize()
    ref = ref.cpu()
    first_eq = bool((ref[:, 1] == toks_c[:, 1]).all())
    share = float((ref[:, 1:] == toks_c[:, 1:]).float().mean())
    print(f"plain path: {BATCH / (time.perf_counter() - t0):.2f} captions/s; first tokens "
          f"equal in every row: {first_eq}; share of all tokens equal: {share:.4f}")
    if not first_eq:
        raise AssertionError("first generated tokens differ from the plain path")

    sources = {"int8_matmul_t_argmax": ("int8_argmax.cu", "vlm_bridge_tpu/ops/quant.py:169"),
               "fused_stack_step": ("stack_step.cu", "vlm_bridge_tpu/ops/decode_kernels.py:707"),
               "fused_bridge_step": ("bridge_step.cu",
                                     "vlm_bridge_tpu/ops/decode_kernels.py:1228")}
    kernels = [{"name": name, "route": "cuda",
                "source": f"vlm_bridge_tpu_torch/csrc/{src}", "replaces": rep,
                "launches": launches[name], **results[name]}
               for name, (src, rep) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
