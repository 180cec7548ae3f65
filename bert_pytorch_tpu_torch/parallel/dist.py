"""Process helpers and the port's collectives (counterpart of
bert_pytorch_tpu/parallel/dist.py).

The reference wrapped torch.distributed's rank, world and barrier around
an NCCL process group initialized from env:// (run_pretraining.py:175);
the JAX package replaced that layer with jax.distributed. The port goes
back to torch.distributed: `initialize()` reads torchrun's environment
(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and joins the
default group, NCCL for a CUDA run and gloo for a CPU one; without that
environment it is world 1 and makes no group. A rank's card is
cuda:LOCAL_RANK. Beside the default group a gloo group carries the
host-side control messages (the preemption vote, the restore step), so
they never wait behind the card's queue.

The collectives the data-parallel step uses (`all_reduce_sum`,
`reduce_scatter_sum`, `all_gather_into`, `all_gather_rows`) take flat
1-D tensors. `all_reduce_sum` is a reduce-scatter followed by an
all-gather (the two phases of a ring all-reduce), so the sum each
element gets is the reduce-scatter's at any world size: ZeRO-1's
all-reduce-then-slice arm and its reduce-scatter arm (--zero1_rs) agree
bit for bit by construction. A failed collective raises; nothing falls
back. Every call adds its payload to `STATS` (calls and bytes by op, and
the host seconds spent in the call: the whole transfer on gloo, the
enqueue alone on NCCL, whose work runs on its own stream).
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Dict, Optional

import torch
import torch.distributed as dist

_CONTROL = None          # the gloo group of host-side control messages
_OWNED = False           # True when initialize() made the default group
# op -> {"calls", "bytes", "host_s"}: every collective of this process
STATS: Dict[str, Dict[str, float]] = {}


def _env_int(key: str) -> Optional[int]:
    v = os.environ.get(key)
    return int(v) if v not in (None, "") else None


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def initialize(device: str = "cuda", backend: Optional[str] = None,
               init_method: Optional[str] = None,
               rank: Optional[int] = None,
               world_size: Optional[int] = None,
               timeout_s: float = 600.0) -> bool:
    """Join the default process group, once. The rank and the world size
    come from the arguments, else torchrun's RANK / WORLD_SIZE; the
    rendezvous from `init_method`, else env:// (MASTER_ADDR /
    MASTER_PORT). `backend`: NCCL for `device` "cuda", gloo for "cpu"
    unless given (an internal argument, no CLI flag: it lets two ranks
    share one card over gloo). Without a world size (no torchrun
    environment) it is world 1 and no group is made. Returns whether a
    group exists. A group already made (by a caller) is kept as it is.
    The rendezvous waits at most `timeout_s`, and so does a collective
    before it raises."""
    global _CONTROL, _OWNED
    if is_initialized():
        _ensure_control()
        return True
    world = world_size if world_size is not None else _env_int("WORLD_SIZE")
    if world is None:
        return False
    rank = rank if rank is not None else _env_int("RANK") or 0
    if backend is None:
        backend = "nccl" if str(device).startswith("cuda") else "gloo"
    if backend == "nccl" and str(device).startswith("cuda"):
        torch.cuda.set_device(local_device("cuda"))
    dist.init_process_group(
        backend=backend, init_method=init_method or "env://", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    _OWNED = True
    _ensure_control()
    return True


def _ensure_control() -> None:
    global _CONTROL
    if _CONTROL is None:
        _CONTROL = (dist.new_group(backend="gloo")
                    if dist.get_backend() != "gloo" else dist.group.WORLD)


def shutdown() -> None:
    """Destroy the default group if `initialize` made it (a caller's own
    group stays)."""
    global _CONTROL, _OWNED
    if _OWNED and is_initialized():
        dist.destroy_process_group()
    _CONTROL, _OWNED = None, False


def get_rank() -> int:
    """The rank in the default group; 0 without one (reference
    src/utils.py:29-35)."""
    return dist.get_rank() if is_initialized() else 0


def get_world_size() -> int:
    """The ranks in the default group; 1 without one."""
    return dist.get_world_size() if is_initialized() else 1


def is_main_process() -> bool:
    """rank 0: the rank that logs, writes the sinks and the checkpoints."""
    return get_rank() == 0


def barrier() -> None:
    """Every rank waits for the others (host side, on the control
    group); nothing without a group."""
    if is_initialized():
        dist.barrier(group=_CONTROL)


def local_device(device: str = "cuda") -> torch.device:
    """This rank's device: cuda:LOCAL_RANK for "cuda", the CPU for
    "cpu"."""
    if str(device).startswith("cpu"):
        return torch.device("cpu")
    return torch.device("cuda", _env_int("LOCAL_RANK") or 0)


def agree_any(flag: bool) -> bool:
    """True when `flag` is true on any rank (a host-side MAX over the
    control group); `flag` itself without a group."""
    if not is_initialized() or get_world_size() == 1:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=_CONTROL)
    return bool(t.item())


def backend() -> Optional[str]:
    """The default group's backend ("nccl", "gloo"), None without one."""
    return dist.get_backend() if is_initialized() else None


def all_gather_object(obj) -> list:
    """Every rank's `obj`, in rank order (host side, control group)."""
    if not is_initialized() or get_world_size() == 1:
        return [obj]
    out = [None] * get_world_size()
    dist.all_gather_object(out, obj, group=_CONTROL)
    return out


def broadcast_object(obj, src: int = 0):
    """`obj` of rank `src` on every rank (host side, control group)."""
    if not is_initialized() or get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=_CONTROL)
    return box[0]


# -- the data path's collectives ---------------------------------------------


def _count(op: str, t: torch.Tensor, t0: float) -> None:
    s = STATS.setdefault(op, {"calls": 0, "bytes": 0, "host_s": 0.0})
    s["calls"] += 1
    s["bytes"] += t.numel() * t.element_size()
    s["host_s"] += time.perf_counter() - t0


def reset_stats() -> None:
    STATS.clear()


def stats_total() -> Dict[str, float]:
    """STATS summed over the ops: {"calls", "bytes", "host_s"}."""
    out = {"calls": 0, "bytes": 0, "host_s": 0.0}
    for s in STATS.values():
        for k in out:
            out[k] += s[k]
    return out


def _world() -> int:
    return get_world_size() if is_initialized() else 1


def reduce_scatter_sum(out: torch.Tensor, flat: torch.Tensor,
                       async_op: bool = False):
    """out <- rank r's 1/N slice of the sum over ranks of `flat` (1-D,
    its length a multiple of the world size). Without a group, a copy."""
    t0 = time.perf_counter()
    if not is_initialized():
        out.copy_(flat)
        return None
    work = dist.reduce_scatter_tensor(out, flat, op=dist.ReduceOp.SUM,
                                      async_op=async_op)
    _count("reduce_scatter", flat, t0)
    return work


def all_gather_into(out: torch.Tensor, shard: torch.Tensor,
                    async_op: bool = False):
    """out <- the ranks' `shard`s in rank order (out holds N of them).
    `async_op` returns the work to wait on (None without a group, where
    it is a copy)."""
    t0 = time.perf_counter()
    if not is_initialized():
        out.copy_(shard)
        return None
    work = dist.all_gather_into_tensor(out, shard, async_op=async_op)
    _count("all_gather", out, t0)
    return work


def all_reduce_sum(flat: torch.Tensor) -> None:
    """flat <- the sum over ranks of `flat`, in place (1-D, its length a
    multiple of the world size): a reduce-scatter, then an all-gather of
    the reduced slices, so every element's sum is the one
    `reduce_scatter_sum` gives it."""
    n = _world()
    if n == 1 and not is_initialized():
        return
    part = torch.empty(flat.numel() // n, dtype=flat.dtype,
                       device=flat.device)
    reduce_scatter_sum(part, flat)
    all_gather_into(flat, part)


def all_reduce_small(t: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of a small tensor (counts, a loss), in place,
    by the backend's own all-reduce; returned."""
    t0 = time.perf_counter()
    if is_initialized():
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        _count("all_reduce", t, t0)
    return t


def all_gather_rows(vec: torch.Tensor) -> torch.Tensor:
    """(N, k): row r is rank r's 1-D `vec` (k values)."""
    n = _world()
    out = torch.empty((n, vec.numel()), dtype=vec.dtype, device=vec.device)
    all_gather_into(out.view(-1), vec.reshape(-1))
    return out


def sum_rows_in_order(rows: torch.Tensor) -> torch.Tensor:
    """rows[0] + rows[1] + ... in rank order, one add a rank: the same
    rounding whatever the row width, so a value summed alone or inside a
    bucket gets the same bits."""
    acc = rows[0].clone()
    for r in range(1, rows.shape[0]):
        acc += rows[r]
    return acc
