"""Faults of the routed experts, planted underneath the timed path as
portbench.faults plants its own (context managers that patch the port's
module attributes at call time): the stacked decode step is handed a
config that routes to one expert fewer, or leaves the weights as the
softmax gave them, or a stacked copy whose expert 0 adds nothing (its down
scales zero: the rows routed to it lose that expert's share).

    python3 -m portbench.control_moe --workload CELL --seeds 11,12 --fault top7"""

from __future__ import annotations

import dataclasses

from portbench.patch import patched


def _stacked_step(change_cfg=None, change_stacked=None):
    from vlm_bridge_tpu_torch.models import gemma2

    copies = {}

    def make(fn):
        def step(params, cfg, stacked, *a, **kw):
            if change_cfg is not None:
                cfg = change_cfg(cfg)
            if change_stacked is not None:
                if id(stacked) not in copies:
                    copies[id(stacked)] = (stacked, change_stacked(stacked))
                stacked = copies[id(stacked)][1]
            return fn(params, cfg, stacked, *a, **kw)
        return step
    return patched(gemma2, "decode_step_stacked", make)


def fewer_experts():
    """Each row routes to k - 1 experts (top-7 of Mellum2's 8)."""
    return _stacked_step(change_cfg=lambda c: dataclasses.replace(
        c, experts_per_token=c.experts_per_token - 1))


def unrenormalized():
    """The k weights are the softmax's, not renormalized over the k."""
    return _stacked_step(change_cfg=lambda c: dataclasses.replace(c, norm_topk_prob=False))


def dropped_expert():
    """Expert 0 of every layer adds nothing to the rows routed to it."""
    def drop(stacked):
        out = dict(stacked)
        out["ed_scale"] = stacked["ed_scale"].clone()
        out["ed_scale"][:, 0] = 0.0
        return out
    return _stacked_step(change_stacked=drop)


SERVING = {"top7": fewer_experts, "unrenormalized": unrenormalized,
           "dropped_expert": dropped_expert}
