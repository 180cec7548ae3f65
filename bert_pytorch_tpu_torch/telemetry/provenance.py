"""Run provenance stamps (counterpart of
bert_pytorch_tpu/telemetry/provenance.py).

A log found later is evidence only if it says what produced it: the git
commit, torch and CUDA, and the card with its power limit (a card set
below its maximum runs slower under load). Every field degrades to
"unknown" rather than raising: a provenance stamp must never be the
thing that stops a run.
"""

from __future__ import annotations

import os
import platform
import subprocess
import time
from typing import Any, Dict, Optional

import torch


def _run(cmd, cwd: Optional[str] = None) -> str:
    try:
        return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                              timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def git_sha() -> str:
    """Short SHA (+'-dirty' when the tree is modified) of the checkout
    holding this file; 'unknown' outside a git checkout."""
    cwd = os.path.dirname(os.path.abspath(__file__))
    sha = _run(["git", "rev-parse", "--short", "HEAD"], cwd)
    if not sha:
        return "unknown"
    dirty = _run(["git", "status", "--porcelain", "--untracked-files=no"],
                 cwd)
    return sha + ("-dirty" if dirty else "")


def collect_provenance(device=None) -> Dict[str, Any]:
    """One provenance dict for a log header: the commit, the versions, and
    for a CUDA `device` the card's name, count and power limit as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    reports them."""
    dev = torch.device(device) if device is not None else None
    out: Dict[str, Any] = {
        "git_sha": git_sha(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda or "none",
        "python_version": platform.python_version(),
        "time_unix": round(time.time(), 3),
        "platform": "gpu" if dev is not None and dev.type == "cuda"
        else "cpu",
    }
    if dev is not None and dev.type == "cuda":
        index = dev.index if dev.index is not None else 0
        out["device_kind"] = torch.cuda.get_device_name(index)
        out["device_count"] = torch.cuda.device_count()
        smi = _run(["nvidia-smi", f"--id={index}",
                    "--query-gpu=name,power.limit",
                    "--format=csv,noheader"])
        out["nvidia_smi"] = smi or "unknown"
    else:
        out["device_kind"] = platform.processor() or platform.machine()
    return out
