"""Fake quantizers: each returns the f32 values a quantized weight or cache
row stands for (symmetric absmax scales, round half to even, as torch.round
does). They follow the serving recipes' definitions: int8 per output channel
of an [in, out] weight or per row of a [V, H] table; int4 in -7..7 with one
scale per group of rows of the contraction (or per channel); the int4 MLP
built from the int8 reconstruction; the int8 KV cache per key or value
vector; fp8 e4m3 with one scale per tensor."""

from __future__ import annotations

from typing import Optional

import torch


def int8(w: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """axis: the contraction axis, over which one scale is taken."""
    wf = w.float()
    scale = torch.clamp(wf.abs().amax(dim=axis, keepdim=True), min=1e-12) / 127.0
    return torch.clamp(torch.round(wf / scale), -127, 127) * scale


def int4(w: torch.Tensor, group: Optional[int] = 128) -> torch.Tensor:
    """[K, N] weight, int4 with one scale per `group` rows of K per column
    (None: one per column)."""
    wf = w.float()
    K, N = wf.shape
    if group is None:
        scale = torch.clamp(wf.abs().amax(dim=0, keepdim=True), min=1e-12) / 7.0
        return torch.clamp(torch.round(wf / scale), -7, 7) * scale
    g = wf.reshape(K // group, group, N)
    scale = torch.clamp(g.abs().amax(dim=1, keepdim=True), min=1e-12) / 7.0
    return (torch.clamp(torch.round(g / scale), -7, 7) * scale).reshape(K, N)


def int4_rows(table: torch.Tensor, group: Optional[int] = 128) -> torch.Tensor:
    """[V, H] table, int4 with one scale per `group` columns of each row
    (None: one per row)."""
    return int4(table.T, group).T


def int4_table_group(hidden: int) -> Optional[int]:
    """The int4 table's group: 128 where H/2 holds whole groups of 128."""
    return 128 if (hidden // 2) % 128 == 0 else None


def kv8(x: torch.Tensor) -> torch.Tensor:
    """Per-vector int8 over the trailing dim (the int8 KV and cross caches)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-12) / 127.0
    return torch.clamp(torch.round(xf / scale), -127, 127) * scale


def fp8(x: torch.Tensor) -> torch.Tensor:
    """e4m3 with one scale per tensor (amax to 448), back in f32; the
    gradient passes straight through to x."""
    xf = x.float()
    scale = torch.clamp(xf.detach().abs().amax(), min=1e-12) / 448.0
    q = (xf.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return xf + (q - xf.detach())


def weight(w: torch.Tensor, form: Optional[str], axis: int = 0) -> torch.Tensor:
    """A weight as a recipe serves it. form: None (float), "int8",
    "int4g128", "int4g128_of_int8" (int4 built from the int8
    reconstruction), "int4" (per channel), "int4_rows" (a table, grouped as
    `int4_table_group` says)."""
    if form is None:
        return w.float()
    if form == "int8":
        return int8(w, axis)
    if form == "int4g128":
        return int4(w, 128)
    if form == "int4g128_of_int8":
        return int4(int8(w, 0), 128)
    if form == "int4":
        return int4(w, None)
    if form == "int4_rows":
        return int4_rows(w, int4_table_group(w.shape[1]))
    raise ValueError(f"unknown weight form {form!r}")
