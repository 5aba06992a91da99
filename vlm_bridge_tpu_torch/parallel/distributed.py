"""The process group of data-parallel training and eval (port of
vlm_bridge_tpu.parallel.distributed, over torch.distributed).

One process per card. `init_multihost` joins the group; the same
`vlm-training-torch` invocation then runs on one process or under
`torchrun --nproc-per-node N`. Resolution order of the coordinator and the
process's place:
  1. explicit arguments;
  2. the launcher's environment: MASTER_ADDR / MASTER_PORT / WORLD_SIZE /
     RANK (and LOCAL_RANK for the card), as torchrun sets them.
With neither it returns False and does nothing. Where the JAX module warns and
carries on single-host when the initialisation fails, this one raises: a job
of N processes that quietly trains N separate bridges hides the failure.

The group's backend is NCCL on CUDA devices and gloo on the CPU. The helpers
below (`rank`, `world_size`, `barrier`, `all_reduce_sum`, `all_gather_rows`)
are no-ops without a group.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import List, Optional

import torch
import torch.distributed as dist


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None, *,
                   device="cuda", timeout_s: float = 600.0) -> bool:
    """Join the process group if a coordinator is given or in the
    environment. Returns True if this process is in a group (one that was
    already initialised counts), False for the single-process no-op.

    coordinator_address: "host:port" of rank 0's rendezvous. device: "cuda"
    (NCCL; binds LOCAL_RANK's card, else process_id's modulo the cards) or
    "cpu" (gloo)."""
    if is_initialized():
        return True
    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])
    if not coordinator_address:
        return False
    if num_processes is None or process_id is None:
        raise ValueError(f"coordinator {coordinator_address} given without the world size and "
                         "this process's rank (arguments, or WORLD_SIZE / RANK)")
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA process group was asked for but torch.cuda.is_available() "
                               "is False")
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else process_id % torch.cuda.device_count())
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=timedelta(seconds=timeout_s))
    return True


def process_info() -> dict:
    """Processes and devices, for logs (the JAX module's keys)."""
    group = is_initialized()
    cuda = group and dist.get_backend() == "nccl"
    return {"process_index": rank(),
            "process_count": world_size(),
            "local_devices": torch.cuda.device_count() if cuda else 1,
            "global_devices": world_size(),
            "backend": dist.get_backend() if group else "none"}


def barrier() -> None:
    if not is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def all_reduce_sum(tensors: List[torch.Tensor], group=None) -> List[torch.Tensor]:
    """The sum over `group` (None: the whole group) of each tensor, through
    one flat buffer (one collective); new tensors, in the inputs' shapes.
    Without a process group, the inputs themselves."""
    if not is_initialized():
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def all_reduce_f32(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over `group`, added in f32 and returned in x's dtype (a
    new tensor): tensor parallelism's partial products. gloo, which the CPU
    runs and two processes sharing one card use, sums CUDA tensors through
    the host; NCCL on the card."""
    y = x.float().contiguous()
    if y.data_ptr() == x.data_ptr():
        y = y.clone()
    dist.all_reduce(y, group=group)
    return y.to(x.dtype)


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """The equal-shaped blocks of rows of `group`'s ranks (None: the whole
    group) stacked in rank order along dim 0; x itself without a process
    group or in a group of one."""
    if not is_initialized() or dist.get_world_size(group) == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=0)
