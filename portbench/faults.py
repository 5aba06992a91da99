"""Faults planted underneath the timed path, for the tests that see
`correct` come out false and for reading a fault's numbers on the card
(python3 -m portbench.control --fault NAME). Each is a context manager
that patches the port's module attributes the timed path looks up at call
time, and restores them."""

from __future__ import annotations

from portbench.patch import patched


def stale_cache():
    """Serving: the stack step's KV cache is never written (each step
    writes into copies), so every step attends to an empty cache."""
    from vlm_bridge_tpu_torch.ops import decode_kernels

    def make(fn):
        def step(t, x, stacked, kc, vc, ks, vs, *a, **kw):
            return fn(t, x, stacked, kc.clone(), vc.clone(), ks.clone(), vs.clone(), *a, **kw)
        return step
    return patched(decode_kernels, "fused_stack_step", make)


def altered_token():
    """Serving: one token of every row is replaced where it is produced."""
    from vlm_bridge_tpu_torch.inference import generate

    def make(fn):
        def gen(params, cfg, **kw):
            toks, lens = fn(params, cfg, **kw)
            col = toks.shape[1] // 2
            toks[:, col] = (toks[:, col] + 7) % cfg.lm.vocab_size
            return toks, lens
        return gen
    return patched(generate, "generate_tokens", make)


def half_batch_caption():
    """Serving: only the first half of the batch is decoded; the second
    half's rows repeat it."""
    from vlm_bridge_tpu_torch.inference import generate

    def make(fn):
        def gen(params, cfg, *, vision_features, **kw):
            half = vision_features.shape[0] // 2
            toks, lens = fn(params, cfg, vision_features=vision_features[:half], **kw)
            reps = -(-vision_features.shape[0] // half)
            n = vision_features.shape[0]
            return toks.repeat(reps, 1)[:n], lens.repeat(reps)[:n]
        return gen
    return patched(generate, "generate_tokens", make)


def unchanged_state():
    """Training: the optimizer never updates the state."""
    from vlm_bridge_tpu_torch.training import train_step as ts

    return patched(ts.BridgeOptimizer, "update", lambda fn: lambda self, *a, **kw: None)


def half_batch_train():
    """Training: half of the batch is left out, the mean taken over the rest."""
    from vlm_bridge_tpu_torch.training import train_step as ts

    def make(fn):
        def build(*a, **kw):
            step = fn(*a, **kw)

            def half(state, frozen, batch, generator):
                n = next(iter(batch.values())).shape[0] // 2
                return step(state, frozen, {k: v[:n] for k, v in batch.items()}, generator)
            return half
        return build
    return patched(ts, "make_train_step", make)


SERVING = {"stale_cache": stale_cache, "altered_token": altered_token,
           "half_batch": half_batch_caption}
TRAINING = {"unchanged_state": unchanged_state, "half_batch": half_batch_train}
