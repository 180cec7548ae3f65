"""Checkpoints and auto-resume (counterpart of
bert_pytorch_tpu/training/checkpoint.py, in the port's own format).

A checkpoint is a step directory `<directory>/<global_step>/` holding
`state.pt` (torch.save of TrainState.state_dict(): the step, the f32
parameters by name, LAMB's count, mu and nu by name), `extra.json` (the
sampler cursor, the epoch, an echo of the run config) and the integrity
sidecar of resilience/manifest.py. The reference's policy, as the JAX
package keeps it:

- a save every `num_steps_per_checkpoint` steps and at the end of the run,
  named by the global step (which includes previous_phase_end_step), so
  phase 2 in phase 1's output directory resumes phase 1's last state with
  its moments (the two-phase handoff);
- a rolling window of the newest `max_to_keep`;
- auto-resume from the newest step that verifies: a corrupt step is
  quarantined (`<step>.corrupt`) and the walk goes on to the next-newest.

A save writes the data files into `<step>.tmp-<pid>/`, then the sidecar
(its digests of the complete files), then commits the step with one
rename: a step directory either is whole or does not exist.
`freshness()` (the newest save or restore) feeds /healthz and the train
SLO `checkpoint_age_s`.

`load_jax_checkpoint` reads the parameters of a JAX-package (orbax)
checkpoint directory through tensorstore alone, without orbax or jax:
each leaf of `<dir>/<step>/state` is a zarr array in its OCDBT store,
named by its tree path joined with ".".
"""

from __future__ import annotations

import ast
import json
import os
import shutil
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from bert_pytorch_tpu_torch.resilience.manifest import (
    CorruptCheckpointError, all_steps_on_disk, quarantine_step,
    step_dir_path, verify_step_dir, write_step_manifest)

STATE_FILE = "state.pt"
EXTRA_FILE = "extra.json"


class CheckpointManager:
    """Save, list and restore the step directories under `directory`."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 log: Callable[[str], None] = print):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self._log = log
        # the newest save or restore of this process: (step, unix time)
        self._fresh: Tuple[Optional[int], Optional[float]] = (None, None)

    def all_steps(self) -> List[int]:
        """Every committed step, ascending."""
        return all_steps_on_disk(self.directory)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Dict[str, Any],
             extra: Optional[Dict[str, Any]] = None) -> Dict[str, float]:
        """Write and commit step `step`, then drop the oldest steps beyond
        the window. Returns the bytes written and the seconds taken."""
        t0 = time.perf_counter()
        os.makedirs(self.directory, exist_ok=True)
        final = step_dir_path(self.directory, step)
        tmp = f"{final}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, STATE_FILE))
        with open(os.path.join(tmp, EXTRA_FILE), "w", encoding="utf-8") as f:
            json.dump(extra or {}, f, indent=1, sort_keys=True)
        write_step_manifest(tmp, step, extra_echo=extra)
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(step_dir_path(self.directory, old),
                          ignore_errors=True)
        nbytes = sum(os.path.getsize(os.path.join(final, f))
                     for f in os.listdir(final))
        self._fresh = (int(step), time.time())
        return {"bytes": nbytes, "seconds": time.perf_counter() - t0}

    def freshness(self) -> Tuple[Optional[int], Optional[float]]:
        """(step, unix time) of this process's newest save or restore;
        before either, the newest step on disk and its directory's mtime
        ((None, None) without one)."""
        if self._fresh[0] is not None:
            return self._fresh
        step = self.latest_step()
        if step is None:
            return None, None
        try:
            return step, os.path.getmtime(step_dir_path(self.directory,
                                                        step))
        except OSError:
            return step, None

    def verify(self, step: int) -> List[str]:
        """[] when the step matches its sidecar, else the errors."""
        return verify_step_dir(step_dir_path(self.directory, step))

    def restore(self, step: Optional[int] = None,
                map_location: Any = "cpu", mmap: bool = False
                ) -> Tuple[Dict[str, Any], Dict[str, Any], int]:
        """(state_dict, extra, step) of `step` (default the newest).
        Digests are verified before anything is deserialised: a corrupt
        step raises CorruptCheckpointError naming the failed item.
        `mmap`: the tensors map the state file and are read only where
        they are used."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(
                f"no checkpoint found under {self.directory}")
        errors = self.verify(step)
        if errors:
            raise CorruptCheckpointError(step, errors)
        return self._load(step, map_location, mmap)

    def _load(self, step: int, map_location: Any, mmap: bool = False
              ) -> Tuple[Dict[str, Any], Dict[str, Any], int]:
        sd = step_dir_path(self.directory, step)
        if not os.path.isdir(sd):
            raise FileNotFoundError(f"no checkpoint step {step} under "
                                    f"{self.directory}")
        state = torch.load(os.path.join(sd, STATE_FILE),
                           map_location=map_location, weights_only=True,
                           mmap=mmap)
        with open(os.path.join(sd, EXTRA_FILE), encoding="utf-8") as f:
            extra = json.load(f)
        self._fresh = (int(step), time.time())
        return state, extra, step

    def restore_with_fallback(self, map_location: Any = "cpu"
                              ) -> Tuple[Dict[str, Any], Dict[str, Any],
                                         int]:
        """Auto-resume that survives a torn or corrupt newest checkpoint:
        walk the steps newest to oldest; a step that fails verification
        (a missing sidecar included) is quarantined with a warning naming
        the failed item and the walk goes on. A step whose digests verify
        but which still fails to load is raised as it is: intact data that
        will not load is not corruption.

        Raises CorruptCheckpointError when every step was quarantined,
        FileNotFoundError when there were none."""
        steps = self.all_steps()
        if not steps:
            raise FileNotFoundError(
                f"no checkpoint found under {self.directory}")
        quarantined: List[int] = []
        for step in reversed(steps):
            errors = self.verify(step)
            if not errors:
                return self._load(step, map_location)
            dst = quarantine_step(self.directory, step)
            quarantined.append(step)
            self._log(f"WARNING: checkpoint step {step} is CORRUPT — "
                      f"{'; '.join(errors)}. Quarantined to {dst}; "
                      "auto-resume falls back to the next-newest checkpoint")
        raise CorruptCheckpointError(
            None, [f"every checkpoint under {self.directory} failed "
                   f"verification; quarantined steps: {quarantined}"])


def parse_init_checkpoint(spec: str) -> Tuple[str, Optional[int]]:
    """'<dir>[@step]' -> (dir, step or None for the newest)."""
    head, sep, tail = spec.rpartition("@")
    if sep and tail.isdigit():
        return head, int(tail)
    return spec, None


def load_params(spec: str, log: Callable[[str], None] = print
                ) -> Tuple[Dict[str, torch.Tensor], int]:
    """(the parameters by name, the step) of a port checkpoint
    `<checkpoint dir>[@step]` (default the newest step), on the CPU. The
    state file is mapped: the optimizer moments beside the parameters are
    never read into memory."""
    directory, step = parse_init_checkpoint(spec)
    state, _, step = CheckpointManager(directory, log=log).restore(
        step, map_location="cpu", mmap=True)
    return state["params"], step


ORBAX_METADATA = os.path.join("state", "_METADATA")


def orbax_steps(directory: str) -> List[int]:
    """The steps of `directory` that hold a JAX-package (orbax)
    checkpoint (`<step>/state/_METADATA`, where a port step holds
    `state.pt`), ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(d) for d in os.listdir(directory) if d.isdigit()
                  and os.path.isfile(os.path.join(directory, d,
                                                  ORBAX_METADATA)))


def load_jax_checkpoint(spec: str) -> Tuple[Dict[str, np.ndarray], int]:
    """(the flat flax parameter tree, keys joined with "/", as numpy; the
    step) of a JAX-package checkpoint directory `<dir>[@step]` (default
    the newest step), read through tensorstore without orbax or jax. Both
    encoder layouts come back as saved (a scan-stacked checkpoint's
    leaves carry the layer axis first); bf16 leaves come back as
    ml_dtypes.bfloat16. Raises ImportError naming tensorstore when it is
    not installed."""
    directory, step = parse_init_checkpoint(spec)
    steps = orbax_steps(directory)
    if step is None:
        if not steps:
            raise FileNotFoundError(f"no orbax checkpoint step under "
                                    f"{directory}")
        step = steps[-1]
    elif step not in steps:
        raise FileNotFoundError(f"no orbax checkpoint step {step} under "
                                f"{directory} (found {steps})")
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError(
            "reading a JAX (orbax) checkpoint needs the tensorstore "
            "package, which is not installed") from e
    step_dir = step_dir_path(directory, step)
    state_dir = os.path.join(step_dir, "state")
    with open(os.path.join(state_dir, "_METADATA"), encoding="utf-8") as f:
        meta = json.load(f)
    driver = "zarr3" if meta.get("use_zarr3") else "zarr"
    out: Dict[str, np.ndarray] = {}
    for key, leaf in meta["tree_metadata"].items():
        names = ([k["key"] for k in leaf["key_metadata"]]
                 if "key_metadata" in leaf else list(ast.literal_eval(key)))
        if not names or names[0] != "params":
            continue
        arr = ts.open({"driver": driver,
                       "kvstore": {"driver": "ocdbt",
                                   "base": f"file://{state_dir}"},
                       "path": ".".join(names)}, read=True).result()
        out["/".join(names[1:])] = np.asarray(arr.read().result())
    if not out:
        raise ValueError(f"orbax checkpoint {step_dir} holds no params")
    return out, step


# The names of a distillation run's student -> teacher projections
# (training/distill.py), which its checkpoint carries beside the model's
# own parameters and a model restore drops, as the JAX serving restore
# ignores them.
PROJ_PREFIX = "distill_proj."


def model_params_only(state: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """`state` without the training-only parameters (the projections)."""
    return {k: v for k, v in state.items()
            if not k.startswith(PROJ_PREFIX)}


def encoder_layer_count(names) -> Optional[int]:
    """The encoder depth a set of parameter names holds
    (`...encoder.layers.<i>....`), None without an encoder."""
    idx = set()
    for name in names:
        head, sep, tail = name.partition("encoder.layers.")
        if sep and tail.split(".", 1)[0].isdigit():
            idx.add(int(tail.split(".", 1)[0]))
    return max(idx) + 1 if idx else None


def strict_load_state(model, state: Dict[str, torch.Tensor]) -> None:
    """Load `state` into `model` requiring every model parameter with its
    exact shape and no parameter the model lacks (a distillation
    checkpoint's projections too: `model_params_only` drops them where
    the checkpoint is read). A mismatch raises naming the parameters;
    when the two disagree on encoder depth (a distilled student's
    checkpoint under the teacher's config, or the reverse) the error leads
    with both layer counts and the student's model_config.json, as the
    JAX serving restore's does."""
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    missing = [k if k not in state else
               f"{k} (shape {tuple(state[k].shape)} != {shape})"
               for k, shape in want.items()
               if k not in state or tuple(state[k].shape) != shape]
    unexpected = sorted(set(state) - set(want))
    if missing or unexpected:
        msg = ("serving restore is strict — checkpoint is missing "
               f"{len(missing)} required param leaf/leaves: "
               + ", ".join(sorted(missing)[:8])
               + ("..." if len(missing) > 8 else ""))
        if unexpected:
            msg += (f"; and carries {len(unexpected)} the model lacks: "
                    + ", ".join(unexpected[:8])
                    + ("..." if len(unexpected) > 8 else ""))
        want_layers = encoder_layer_count(want)
        have_layers = encoder_layer_count(state)
        if (want_layers is not None and have_layers is not None
                and want_layers != have_layers):
            msg = (f"serving restore: model config expects {want_layers} "
                   f"encoder layer(s) but the checkpoint carries "
                   f"{have_layers} — config/checkpoint depth mismatch. "
                   "If this checkpoint is a distilled student (run_distill "
                   "--student), point --model_config_file at the "
                   "student's model_config.json (written beside its "
                   "ckpt), not the teacher's. " + msg)
        raise ValueError(msg)
    model.load_state_dict(state, strict=True)
