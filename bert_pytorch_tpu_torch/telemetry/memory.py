"""Device memory in the perf records (counterpart of
bert_pytorch_tpu/telemetry/compile_watch.py's `hbm_snapshot`).

`device_memory_snapshot(device)` returns JAX's three keys, in bytes:
`hbm_peak_bytes` (the caching allocator's peak of allocated bytes since
the process started or since `torch.cuda.reset_peak_memory_stats`),
`hbm_bytes_in_use` (allocated now) and `hbm_bytes_limit` (the card's
total memory). On the CPU it returns {}, as JAX's does on a backend
without memory stats, so a CPU run's records carry no `hbm_*` keys.
run_pretraining adds the snapshot to every pretraining `perf` record, as
the JAX entry point does; finetuning and distillation records carry none
there either.

JAX's CompileWatch (compile counts and seconds, a mid-run recompile
warning) has no counterpart: the port runs eager PyTorch and compiles no
program.
"""

from __future__ import annotations

from typing import Dict


def device_memory_snapshot(device) -> Dict[str, int]:
    """The card's peak, in-use and total bytes; {} off a CUDA device."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    return {
        "hbm_peak_bytes": int(stats.get("allocated_bytes.all.peak", 0)),
        "hbm_bytes_in_use": int(stats.get("allocated_bytes.all.current",
                                          0)),
        "hbm_bytes_limit": int(
            torch.cuda.get_device_properties(device).total_memory),
    }
