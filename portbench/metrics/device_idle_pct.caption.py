"""The share of the traced window in which no kernel, copy or memset ran on
the device, in a caption cell (portbench.tracing.idle_pct)."""

from portbench.tracing import idle_pct as read  # noqa: F401
