"""Flight recorder: the training job's black box (counterpart of
bert_pytorch_tpu/telemetry/flight_recorder.py; the manifest schema, its
version and its validators are the JAX package's, so a bundle of either
validates under both).

When a step goes bad, the health pack says "non-finite gradient in group
X"; the batch and the dropout seeds that produced it are gone by then,
and a crash loses the buffered tail of the metric stream. `FlightRecorder`
keeps them, on the host and bounded:

- a ring of the last `window` steps: the loader's numpy batch (packed
  fields included) and the step's int32 dropout seeds, by step. These are
  references to the arrays the loader made for that batch, not copies, so
  the ring costs at most `window` batches of host memory (`nbytes()`);
- a bounded tail of the newest metric records the loop read back, so the
  bundle says what tripped as well as with what;
- `dump()` writes a repro bundle, `batches.npz` and a `manifest.json`
  with the provenance stamp, the model config and everything
  tools/replay.py needs to rebuild the step (accumulation, optimizer,
  schedule, health action, packing), beside the checkpoints;
- crash handlers: SIGTERM and SIGINT become `SystemExit(128 + signal)`,
  so the entry point's except-path can dump before the process unwinds,
  and an atexit backstop dumps when a run exits armed without a bundle.

Where the JAX run block records its PRNG key, the port records the
step's int32 dropout seeds (training/pretrain.dropout_seeds) in the
record's "rng" slot: what the port's step takes. Plain host Python
(numpy and the standard library): the recorder never touches the card,
and `validate_bundle` runs anywhere.
"""

from __future__ import annotations

import atexit
import json
import math
import os
import re
import signal
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np

MANIFEST_SCHEMA_VERSION = 2

# run-block keys tools/replay.py needs to rebuild the train step; a bundle
# without one fails validation naming it
REQUIRED_RUN_KEYS = (
    "accum_steps", "steps_per_loop", "seed", "max_pred_row", "grad_dtype",
    "optimizer", "learning_rate", "lr_decay", "warmup_proportion",
    "max_steps", "previous_phase_end_step", "rng_impl", "health_pack",
    "nonfinite_action", "zero1", "mesh", "seq_len", "packing",
)

REQUIRED_MANIFEST_KEYS = (
    "schema_version", "reason", "trigger_step", "created_unix",
    "provenance", "model_config", "run", "checkpoint", "records",
    "metrics_tail", "metrics_tail_source", "registry",
)


def _npz_key(step: int, field: str) -> str:
    return f"s{step:08d}__{field}"


def per_host_dir(out_dir: str) -> str:
    """The bundle root of this process: `out_dir`, or `out_dir/hostNNNNN`
    when torch.distributed runs more than one process (each dumps its
    own shard of the data)."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() > 1:
            return os.path.join(out_dir, f"host{dist.get_rank():05d}")
    except Exception:
        pass
    return out_dir


def _json_strict(obj):
    """Non-finite floats as their repr strings ('nan', 'inf'): a
    non-finite bundle's metrics tail holds loss=NaN by construction, and
    bare NaN tokens are not JSON. float('nan') reads them back."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return repr(obj)
    if isinstance(obj, dict):
        return {k: _json_strict(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_strict(v) for v in obj]
    return obj


class FlightRecorder:
    """The bounded black box of the train loop.

        recorder = FlightRecorder(out_dir, window=8, run_info=...,
                                  model_config=..., checkpoint_dir=...,
                                  provenance=...)
        loader.batch_tap = recorder.capture_batch
        recorder.install_crash_handlers(); recorder.arm()
        ...
        recorder.record_dispatch(step, 1, seeds)   # after each step
        recorder.note_metrics(step, vals)          # after each readback
        path = recorder.dump("nonfinite", trigger_step=step)
        ...
        recorder.disarm(); recorder.close()
    """

    def __init__(self, out_dir: str, window: int = 8,
                 metrics_tail: int = 64,
                 run_info: Optional[Dict[str, Any]] = None,
                 model_config: Optional[Dict[str, Any]] = None,
                 checkpoint_dir: Optional[str] = None,
                 provenance: Optional[Dict[str, Any]] = None,
                 checkpoint_step_fn: Optional[Callable[[], Any]] = None,
                 metrics_tail_source: Optional[str] = None,
                 registry=None):
        self.out_dir = out_dir
        self.window = max(1, int(window))
        self.run_info = dict(run_info or {})
        self.model_config = dict(model_config or {})
        self.checkpoint_dir = checkpoint_dir
        self.provenance = dict(provenance or {})
        # the jsonl the tail mirrors and the registry whose snapshot rides
        # in every manifest (TelemetryRun.attach_recorder sets both)
        self.metrics_tail_source = metrics_tail_source
        self.registry = registry
        # a streaming run sets this to its loader's stream_info: the
        # manifest's `stream` then holds the source list, the cursor and
        # the recent batches' record windows at dump time
        self.stream_info_fn: Optional[Callable[[], Dict[str, Any]]] = None
        self._checkpoint_step_fn = checkpoint_step_fn
        self._staged: List[Dict[str, np.ndarray]] = []
        self._records: deque = deque()
        self._tail: deque = deque(maxlen=max(1, int(metrics_tail)))
        self.last_dump: Optional[str] = None
        self._armed = False
        self._old_handlers: Dict[int, Any] = {}
        self._atexit_registered = False

    # -- capture ------------------------------------------------------------

    def capture_batch(self, batch: Dict[str, np.ndarray]) -> None:
        """The loader's tap: stage one yielded batch (on the consumer's
        thread, so in yield order even with assembly running ahead); the
        next record_dispatch binds it to its step."""
        self._staged.append({k: np.asarray(v) for k, v in batch.items()})
        if len(self._staged) > self.window:
            del self._staged[0]

    def record_dispatch(self, first_step: int, n_steps: int,
                        rng: np.ndarray) -> None:
        """Bind the trailing `n_steps` staged batches to steps first_step
        .. first_step + n_steps - 1, with `rng` (the port: the step's
        (accum, sites) int32 dropout seeds, or a --steps_per_loop
        chunk's (n, accum, sites), each record taking its own step's).
        A dispatch wider than the ring keeps its trailing steps; replay
        refuses a chunk whose head was evicted."""
        rng = np.asarray(rng)
        take = self._staged[-n_steps:]
        offset = n_steps - len(take)
        for i, batch in enumerate(take):
            pos = offset + i
            self._records.append({"step": int(first_step + pos),
                                  "pos": int(pos), "n_steps": int(n_steps),
                                  "rng": rng[pos] if rng.ndim == 3 else rng,
                                  "batch": batch})
        self._staged.clear()
        while len(self._records) > self.window:
            self._records.popleft()

    def note_metrics(self, step: int, metrics: Dict[str, Any]) -> None:
        """Append one metric record (host numbers) to the bounded tail."""
        self._tail.append({"step": int(step), **metrics})

    def nbytes(self) -> int:
        """Bytes the ring and the staged batches hold."""
        total = 0
        for rec in self._records:
            total += sum(v.nbytes for v in rec["batch"].values())
        for batch in self._staged:
            total += sum(v.nbytes for v in batch.values())
        return total

    # -- dump ---------------------------------------------------------------

    def dump(self, reason: str, trigger_step: Optional[int] = None) -> str:
        """Write the repro bundle and return its directory. A failed
        write (a full disk) raises: a silently empty black box is worse
        than a second error."""
        reason = re.sub(r"[^A-Za-z0-9_.-]+", "_", str(reason)) or "unknown"
        if trigger_step is None:
            trigger_step = (self._records[-1]["step"] if self._records
                            else 0)
        os.makedirs(self.out_dir, exist_ok=True)
        base = os.path.join(self.out_dir,
                            f"step{int(trigger_step):08d}_{reason}")
        path, n = base, 1
        while os.path.exists(path):
            n += 1
            path = f"{base}_{n}"
        os.makedirs(path)

        arrays: Dict[str, np.ndarray] = {}
        records_meta = []
        for rec in list(self._records):
            sid = rec["step"]
            for k, v in rec["batch"].items():
                arrays[_npz_key(sid, k)] = v
            arrays[_npz_key(sid, "rng")] = rec["rng"]
            records_meta.append({"step": sid, "pos": rec["pos"],
                                 "n_steps": rec["n_steps"],
                                 "fields": sorted(rec["batch"])})
        np.savez(os.path.join(path, "batches.npz"), **arrays)

        latest_ckpt = None
        if self._checkpoint_step_fn is not None:
            try:
                latest_ckpt = self._checkpoint_step_fn()
            except Exception:
                latest_ckpt = None
        manifest = {
            "schema_version": MANIFEST_SCHEMA_VERSION,
            "reason": reason,
            "trigger_step": int(trigger_step),
            "created_unix": round(time.time(), 3),
            "provenance": self.provenance,
            "model_config": self.model_config,
            "run": self.run_info,
            "checkpoint": {"dir": self.checkpoint_dir,
                           "latest_step": latest_ckpt},
            "records": records_meta,
            "metrics_tail": list(self._tail),
            "metrics_tail_source": self.metrics_tail_source,
            "registry": {},
            # the JAX run's compiled-program fingerprint: the port
            # compiles no program
            "program_fingerprint": None,
            "stream": None,
        }
        if self.stream_info_fn is not None:
            try:
                manifest["stream"] = self.stream_info_fn()
            except Exception:
                pass    # a cursor snapshot must not kill the alarm path
        if self.registry is not None:
            try:
                manifest["registry"] = self.registry.snapshot()
            except Exception:
                pass    # a broken snapshot must not kill the alarm path
        with open(os.path.join(path, "manifest.json"), "w",
                  encoding="utf-8") as f:
            json.dump(_json_strict(manifest), f, indent=2, allow_nan=False)
        self.last_dump = path
        return path

    # -- crash safety -------------------------------------------------------

    def arm(self) -> None:
        """Training is in flight: an exit without disarm() is abnormal and
        the atexit backstop dumps."""
        self._armed = True

    def disarm(self) -> None:
        self._armed = False

    def install_crash_handlers(self,
                               signals=(signal.SIGTERM, signal.SIGINT)
                               ) -> None:
        """SIGTERM/SIGINT -> SystemExit(128 + signal), so the loop's
        except-path dumps before the unwind; plus the atexit backstop.
        A handler that cannot be installed (not the main thread) is left
        as it was. Install it before the preemption guard, which chains
        to it."""
        for sig in signals:
            try:
                self._old_handlers[sig] = signal.signal(sig,
                                                        self._on_signal)
            except (ValueError, OSError):
                pass
        if not self._atexit_registered:
            atexit.register(self._atexit_dump)
            self._atexit_registered = True

    def _on_signal(self, signum, frame):
        # the except-path does the dumping, in ordinary code
        raise SystemExit(128 + signum)

    def _atexit_dump(self) -> None:
        if self._armed and self.last_dump is None:
            try:
                self.dump("atexit")
            except Exception:
                pass

    def close(self) -> None:
        """Restore the signal handlers, drop the atexit backstop and
        release the ring. Idempotent."""
        for sig, old in self._old_handlers.items():
            try:
                signal.signal(sig, old)
            except (ValueError, OSError):
                pass
        self._old_handlers.clear()
        if self._atexit_registered:
            atexit.unregister(self._atexit_dump)
            self._atexit_registered = False
        self._armed = False
        self._records.clear()
        self._staged.clear()


# -- bundle schema validation -------------------------------------------------


def validate_manifest(manifest: Any,
                      npz_keys: Optional[set] = None) -> List[str]:
    """The schema errors of a bundle manifest ([] = valid); with
    `npz_keys` (the names in batches.npz) also every record's arrays."""
    errors: List[str] = []
    if not isinstance(manifest, dict):
        return ["manifest is not a JSON object"]
    for key in REQUIRED_MANIFEST_KEYS:
        if key not in manifest:
            errors.append(f"missing manifest key '{key}'")
    if errors:
        return errors
    if manifest["schema_version"] != MANIFEST_SCHEMA_VERSION:
        errors.append(
            f"schema_version {manifest['schema_version']!r} != "
            f"{MANIFEST_SCHEMA_VERSION} (this replay tool)")
    run = manifest["run"]
    if not isinstance(run, dict):
        errors.append("'run' is not an object")
    else:
        for key in REQUIRED_RUN_KEYS:
            if key not in run:
                errors.append(f"missing run key '{key}'")
    mc = manifest["model_config"]
    if not isinstance(mc, dict) or "hidden_size" not in mc \
            or "num_hidden_layers" not in mc:
        errors.append("'model_config' is not a BertConfig dict")
    records = manifest["records"]
    if not isinstance(records, list) or not records:
        errors.append("'records' is empty — nothing to replay")
        records = []
    for rec in records:
        if not isinstance(rec, dict) or not {"step", "pos", "n_steps",
                                             "fields"} <= set(rec):
            errors.append(f"malformed record {rec!r}")
            continue
        if not (0 <= rec["pos"] < rec["n_steps"]):
            errors.append(f"record step {rec['step']}: pos {rec['pos']} "
                          f"outside n_steps {rec['n_steps']}")
        if npz_keys is not None:
            for field in list(rec["fields"]) + ["rng"]:
                key = _npz_key(rec["step"], field)
                if key not in npz_keys:
                    errors.append(f"batches.npz missing array '{key}'")
    if not isinstance(manifest["metrics_tail"], list):
        errors.append("'metrics_tail' is not a list")
    if not isinstance(manifest["registry"], dict):
        errors.append("'registry' is not an object (the metrics-registry "
                      "snapshot at dump time)")
    src = manifest["metrics_tail_source"]
    if src is not None and not isinstance(src, str):
        errors.append("'metrics_tail_source' is neither null nor a path")
    fp = manifest.get("program_fingerprint")
    if fp is not None and (not isinstance(fp, dict)
                           or "collective_counts" not in fp
                           or "donation_hash" not in fp):
        errors.append("'program_fingerprint' present but malformed (want "
                      "collective_counts + donation_hash)")
    stream = manifest.get("stream")
    if stream is not None:
        recent = (stream.get("recent_batches") if isinstance(stream, dict)
                  else None)
        if (not isinstance(stream, dict)
                or not isinstance(stream.get("sources_hash"), str)
                or not isinstance(stream.get("sources"), list)
                or not isinstance(stream.get("cursor"), dict)
                or not isinstance(recent, (list, type(None)))):
            errors.append("'stream' present but malformed (want "
                          "sources_hash + sources + cursor [+ "
                          "recent_batches list])")
        else:
            for w in recent or []:
                if not isinstance(w, dict) or "record_lo" not in w \
                        or "record_hi" not in w:
                    errors.append(
                        f"'stream.recent_batches' entry malformed: {w!r}")
                    break
    return errors


def validate_bundle(bundle_dir: str) -> List[str]:
    """Validate a bundle directory on disk (manifest + npz cross-check)."""
    manifest_path = os.path.join(bundle_dir, "manifest.json")
    npz_path = os.path.join(bundle_dir, "batches.npz")
    if not os.path.isfile(manifest_path):
        return [f"no manifest.json under {bundle_dir}"]
    try:
        with open(manifest_path, encoding="utf-8") as f:
            manifest = json.load(f)
    except Exception as e:
        return [f"manifest.json unreadable: {e}"]
    if not os.path.isfile(npz_path):
        return [f"no batches.npz under {bundle_dir}"]
    try:
        with np.load(npz_path) as npz:
            keys = set(npz.files)
    except Exception as e:
        return [f"batches.npz unreadable: {e}"]
    return validate_manifest(manifest, npz_keys=keys)
