"""Padded row slots over the row slots the expert products computed, over
the traced batches: the program's routing counter
(vlm_bridge_tpu_torch.ops.decode_kernels.moe_counters: rows routed to each
layer's experts) and the row slots its products computed (moe_slot_rows a
call of the step with experts, layer and expert), which the entry copies
into the trace's work. Silent on a program without them."""


def read(trace):
    slots, rows = trace.work.get("moe_slots"), trace.work.get("moe_rows")
    return 100.0 * (slots - rows) / slots if slots and rows is not None else None
