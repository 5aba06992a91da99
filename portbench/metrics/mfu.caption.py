"""A caption batch's share of the card's bf16 peak: the model FLOPs of the
captions of the run's untraced window (the encode, the cross K/V, and the
bridge, decoder and head for every new token; portbench.arith) over the
window's seconds against 989 TFLOP/s (portbench.tracing.mfu_pct)."""

from portbench.tracing import mfu_pct as read  # noqa: F401
