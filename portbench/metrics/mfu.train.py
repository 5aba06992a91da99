"""A train step's share of the card's bf16 peak: the model FLOPs of the
steps of the run's untraced window, over each caption's own tokens and not
the padded bucket (portbench.arith.train_step_flops), over the window's
seconds against 989 TFLOP/s (portbench.tracing.mfu_pct)."""

from portbench.tracing import mfu_pct as read  # noqa: F401
