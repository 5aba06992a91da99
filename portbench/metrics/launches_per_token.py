"""Kernels a token launched while the port's vlm.token span was open: the
eager ops of the decode loop's body (the kernels whose innermost range is
vlm.token or a span in it) and the kernels of the bridge, stack and head
calls (under the benchmark's ranges around those calls, which open inside
the loop's spans); one kernel of the device trace a launch call. Silent on
a program without the span (portbench.spans)."""

from portbench.spans import launches_per_token as read  # noqa: F401
