"""Checkpoint integrity sidecars: digests, verification, quarantine (the
port's own copy of bert_pytorch_tpu/resilience/manifest.py, which needs
only the standard library).

A checkpoint torn by a preemption, a disk that flipped bits, or a stray
partial copy all show up at the worst time: auto-resume fails deep inside
deserialisation. So every committed checkpoint gets a sidecar manifest of
content digests, restore verifies the digests BEFORE deserialising, and a
checkpoint that fails verification is quarantined (renamed
`<step>.corrupt`, recoverable by renaming back) so auto-resume walks to
the next-newest instead of crashing.

Layout (training/checkpoint.py):

    <ckpt_dir>/<step>/                  committed checkpoint
    <ckpt_dir>/<step>/state.pt          TrainState.state_dict() (torch.save)
    <ckpt_dir>/<step>/extra.json        sampler cursor, epoch, run config
    <ckpt_dir>/<step>/integrity.json    this module's sidecar
    <ckpt_dir>/<step>.corrupt/          quarantined (failed verification)

Each top-level file of a step directory is one item of the sidecar; the
sidecar also echoes `extra` (where the data cursor stood), readable
without deserialising anything.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Any, Dict, List, Optional

MANIFEST_NAME = "integrity.json"
MANIFEST_SCHEMA_VERSION = 1
QUARANTINE_SUFFIX = ".corrupt"

_CHUNK = 1 << 20


class CorruptCheckpointError(RuntimeError):
    """A checkpoint failed integrity verification (digest mismatch, torn
    or unreadable sidecar/data). Carries the step and the per-item error
    list so callers can name the failed item in their warning."""

    def __init__(self, step: Optional[int], errors: List[str]):
        self.step = step
        self.errors = list(errors)
        detail = "; ".join(self.errors) or "unknown corruption"
        super().__init__(
            f"checkpoint step {step}: integrity verification failed "
            f"({detail})")


def step_dir_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, str(int(step)))


def _iter_files(step_dir: str):
    """Yield (relpath, abspath) for every file under step_dir except the
    sidecar itself, in sorted order (digests must be path-stable)."""
    out = []
    for root, _dirs, files in os.walk(step_dir):
        for name in files:
            ap = os.path.join(root, name)
            rp = os.path.relpath(ap, step_dir)
            if rp == MANIFEST_NAME:
                continue
            out.append((rp, ap))
    out.sort()
    return out


def compute_item_digests(step_dir: str) -> Dict[str, Dict[str, Any]]:
    """Per-item content digests for a step directory. An "item" is a
    top-level entry of the step dir: a file (`state.pt`, `extra.json`) or
    a directory and everything under it. Each item's sha256 folds every
    file's relative path and bytes, so a missing, renamed, truncated, or
    bit-flipped file all change the digest."""
    items: Dict[str, Any] = {}
    for rp, ap in _iter_files(step_dir):
        head = rp.split(os.sep, 1)[0]
        entry = items.setdefault(
            head, {"hash": hashlib.sha256(), "files": 0, "bytes": 0})
        entry["hash"].update(rp.replace(os.sep, "/").encode("utf-8"))
        entry["hash"].update(b"\0")
        with open(ap, "rb") as f:
            while True:
                chunk = f.read(_CHUNK)
                if not chunk:
                    break
                entry["hash"].update(chunk)
                entry["bytes"] += len(chunk)
        entry["hash"].update(b"\0")
        entry["files"] += 1
    return {
        name: {"sha256": e["hash"].hexdigest(), "files": e["files"],
               "bytes": e["bytes"]}
        for name, e in sorted(items.items())
    }


def write_step_manifest(step_dir: str, step: int,
                        extra_echo: Optional[Dict[str, Any]] = None) -> str:
    """Write the sidecar for a step directory whose data files are
    complete (digests of files still being written would be lies). Atomic
    via tmp+rename; the caller commits the step directory only after it,
    so a committed step always carries its sidecar."""
    manifest = {
        "schema_version": MANIFEST_SCHEMA_VERSION,
        "step": int(step),
        "created_unix": round(time.time(), 3),
        "items": compute_item_digests(step_dir),
        "extra_echo": extra_echo,
    }
    path = os.path.join(step_dir, MANIFEST_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(manifest, f, indent=2, sort_keys=True, default=str)
    os.replace(tmp, path)
    return path


def read_step_manifest(step_dir: str) -> Dict[str, Any]:
    """The sidecar dict. A missing or unreadable sidecar raises
    CorruptCheckpointError: every save writes it before the step is
    committed, so a committed step without a whole sidecar has been torn
    or altered."""
    path = os.path.join(step_dir, MANIFEST_NAME)
    if not os.path.isfile(path):
        raise CorruptCheckpointError(
            _step_of(step_dir), [f"sidecar {MANIFEST_NAME} missing"])
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except Exception as e:
        raise CorruptCheckpointError(
            _step_of(step_dir), [f"sidecar {MANIFEST_NAME} unreadable: {e}"])


def _step_of(step_dir: str) -> Optional[int]:
    try:
        return int(os.path.basename(step_dir.rstrip(os.sep)))
    except ValueError:
        return None


def verify_step_dir(step_dir: str) -> List[str]:
    """Verify a step directory against its sidecar: [] when every item's
    digest matches, else human-readable errors naming each failed item
    (a missing or unreadable sidecar is one)."""
    try:
        manifest = read_step_manifest(step_dir)
    except CorruptCheckpointError as e:
        return e.errors
    want = manifest.get("items")
    if not isinstance(want, dict) or not want:
        return ["sidecar carries no item digests"]
    got = compute_item_digests(step_dir)
    errors: List[str] = []
    for name, meta in sorted(want.items()):
        if name not in got:
            errors.append(f"item '{name}' missing "
                          f"({meta.get('files')} files expected)")
            continue
        if got[name]["sha256"] != meta.get("sha256"):
            errors.append(
                f"item '{name}' digest mismatch "
                f"(want {str(meta.get('sha256'))[:12]}..., got "
                f"{got[name]['sha256'][:12]}...; "
                f"{got[name]['files']} files / {got[name]['bytes']} bytes "
                f"on disk vs {meta.get('files')} / {meta.get('bytes')} "
                "recorded)")
    for name in sorted(set(got) - set(want)):
        errors.append(f"unexpected item '{name}' not covered by the "
                      "sidecar")
    return errors


def quarantine_step(ckpt_dir: str, step: int) -> str:
    """Rename <ckpt_dir>/<step> -> <step>.corrupt (first free suffix) so
    the step scan no longer sees it. Recoverable: renaming back restores
    the checkpoint for offline forensics/repair."""
    src = step_dir_path(ckpt_dir, step)
    dst = src + QUARANTINE_SUFFIX
    n = 1
    while os.path.exists(dst):
        n += 1
        dst = f"{src}{QUARANTINE_SUFFIX}{n}"
    os.replace(src, dst)
    return dst


def all_steps_on_disk(ckpt_dir: str) -> List[int]:
    """Committed checkpoint steps by directory scan — integer-named dirs
    only (quarantined `.corrupt` and in-flight `<step>.tmp-*` dirs never
    parse as ints)."""
    try:
        entries = os.listdir(ckpt_dir)
    except OSError:
        return []
    steps = []
    for name in entries:
        if not os.path.isdir(os.path.join(ckpt_dir, name)):
            continue
        try:
            steps.append(int(name))
        except ValueError:
            continue
    return sorted(steps)
