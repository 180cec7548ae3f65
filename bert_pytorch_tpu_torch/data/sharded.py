"""Sharded-HDF5 pretraining input pipeline (a copy of
bert_pytorch_tpu/data/sharded.py, trimmed to dynamic-masking shards).

The shards are gzip'd HDF5 files with the keys input_ids,
special_token_positions and next_sentence_labels. The loader slices
contiguous batches out of the resident shard and masks them in one
vectorized call (data/masking.py). Masks are a pure function of
(seed, epoch, global sample index), so they do not depend on how samples
were grouped into batches. Each host takes a contiguous chunk of the
global index space, padded by wraparound to world_size * num_samples.

With `packing=True` each batch row is assembled from several short
examples by the first-fit packer of data/packing.py (segment ids,
per-segment positions and per-segment NSP fields); the examples fetched
but not yet placed in a row ride in the loader's state as global sample
indices, so a resume lays out the same rows with the same masks.

`DevicePrefetcher` stages batches on the card ahead of the step that
reads them (run_pretraining's --h2d_prefetch); `cuda_put` is its copy on
a side CUDA stream.
"""

from __future__ import annotations

import bisect
import warnings
from concurrent.futures import Future, ThreadPoolExecutor
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np

from bert_pytorch_tpu_torch import PRETRAIN_GAPS
from bert_pytorch_tpu_torch.data import masking
from bert_pytorch_tpu_torch.data import packing as packing_lib

REQUIRED_KEYS = ("input_ids", "special_token_positions",
                 "next_sentence_labels")


def _h5py():
    try:
        import h5py
    except ImportError as e:  # the one optional dependency of the slice
        raise ImportError(
            "reading pretraining shards needs h5py, which is not installed"
        ) from e
    return h5py


class ShardIndex:
    """Discover and verify shard files, and map a global sample index to
    (file, row). Unreadable files, files that lack input_ids or
    next_sentence_labels, and files whose per-key counts differ are
    skipped with a warning. A legacy premasked file (input_ids without
    special_token_positions), which the JAX loader reads, raises: this
    port does not read that format yet, and skipping it would train on a
    subset of the data. `load(fi)` reads file `fi` whole."""

    def __init__(self, files: Sequence[str]):
        h5py = _h5py()
        self.files: List[str] = []
        self.starts: List[int] = []
        total = 0
        for path in sorted(str(f) for f in files):
            try:
                with h5py.File(path, "r") as f:
                    missing = [k for k in REQUIRED_KEYS if k not in f]
                    counts = {len(f[k]) for k in REQUIRED_KEYS if k in f}
            except OSError as e:
                warnings.warn(f"skipping unreadable shard {path}: {e}")
                continue
            if missing == ["special_token_positions"]:
                raise NotImplementedError(
                    f"{path} is a legacy premasked shard (no "
                    "special_token_positions); reading that format is not "
                    f"ported yet (see {PRETRAIN_GAPS})")
            if missing:
                warnings.warn(f"skipping shard {path}: no {missing}")
                continue
            if len(counts) != 1:
                warnings.warn(f"skipping shard {path}: per-key sample counts "
                              "differ")
                continue
            self.files.append(path)
            self.starts.append(total)
            total += counts.pop()
        if not self.files:
            raise RuntimeError("no valid shard files found")
        self.total = total

    def __len__(self) -> int:
        return self.total

    def locate(self, idx: int) -> Tuple[int, int]:
        """global sample idx -> (file_idx, row_within_file)."""
        if not 0 <= idx < self.total:
            raise IndexError(f"sample {idx} out of range ({self.total})")
        fi = bisect.bisect_right(self.starts, idx) - 1
        return fi, idx - self.starts[fi]

    def file_end(self, fi: int) -> int:
        return self.starts[fi + 1] if fi + 1 < len(self.files) else self.total

    def load(self, fi: int) -> Dict[str, np.ndarray]:
        with _h5py().File(self.files[fi], "r") as f:
            return {k: np.asarray(f[k][:]) for k in REQUIRED_KEYS}

    def seq_len(self) -> int:
        """The sequence length of the shards (the first file's), read
        without loading its arrays."""
        with _h5py().File(self.files[0], "r") as f:
            return int(f["input_ids"].shape[1])


class HostShardSampler:
    """Contiguous per-host index stream: the global index space padded by
    wraparound to world_size * num_samples; host r owns
    [r * num_samples, (r + 1) * num_samples)."""

    def __init__(self, dataset_size: int, world_size: int = 1, rank: int = 0,
                 seed: int = 0):
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} out of range for world {world_size}")
        self.dataset_size = dataset_size
        self.world_size = world_size
        self.rank = rank
        self.seed = seed
        self.num_samples = -(-dataset_size // world_size)
        self.total_size = self.num_samples * self.world_size
        self.index = 0
        self.epoch = 0

    def __len__(self) -> int:
        return self.num_samples

    def next_indices(self, n: int) -> Optional[np.ndarray]:
        """Next n global sample indices, or None at epoch end (a partial
        tail batch is dropped)."""
        if self.index + n > self.num_samples:
            return None
        base = self.rank * self.num_samples + self.index
        self.index += n
        return np.arange(base, base + n) % self.dataset_size

    def reset_epoch(self) -> None:
        self.index = 0
        self.epoch += 1

    def state_dict(self) -> Dict[str, int]:
        return {"epoch": self.epoch, "seed": self.seed,
                "world_size": self.world_size, "total_size": self.total_size,
                "index": self.index}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        """Restore a cursor; one taken over another index space (another
        total_size, as when phase 2 resumes phase 1's checkpoint over its
        own shards) or another world size warns and is not restored."""
        if state.get("total_size") != self.total_size:
            warnings.warn(
                "sampler total_size changed "
                f"({state.get('total_size')} -> {self.total_size}); "
                "not restoring sampler state")
            return
        if state.get("world_size") != self.world_size:
            warnings.warn("world size changed; not restoring sampler state")
            return
        self.epoch = state["epoch"]
        self.seed = state["seed"]
        self.index = state["index"]


class PretrainingDataLoader:
    """Iterator of numpy batches shaped (batch, seq): input_ids,
    token_type_ids, attention_mask, masked_lm_labels, plus
    next_sentence_labels (batch,); all int32. Under `packing` the batch
    is data/packing.py's packed batch (segment_ids, position_ids, and
    per-segment next_sentence_labels and nsp_positions, (batch, G)).

    prefetch_batches > 0 assembles batches (shard reads, row gather,
    masking, packing) on one executor thread that many batches ahead of
    the consumer, so the next batch is ready while the card runs this
    one. `state_dict()` is the loader's state as of the last batch it
    YIELDED (the sampler's cursor and, under packing, the pending
    examples), so a checkpoint taken with assembly running ahead resumes
    without skipping or replaying a batch. `batch_tap(batch)`, when set,
    is called with every batch the loader yields, on the consumer's
    thread (the flight recorder's capture point)."""

    def __init__(self, index: ShardIndex, sampler: HostShardSampler,
                 batch_size: int, mask_token_index: int,
                 max_pred_per_seq: int, masked_lm_prob: float,
                 vocab_size: int, original_token_prob: float = 0.1,
                 random_token_prob: float = 0.1, seed: Optional[int] = None,
                 prefetch_batches: int = 0, packing: bool = False,
                 packing_max_segments: int = 8, packing_lookahead: int = 4,
                 batch_tap: Optional[Callable[[Dict[str, np.ndarray]],
                                              None]] = None):
        if not 0 <= masked_lm_prob <= 1:
            raise ValueError("masked_lm_prob must be in [0,1]")
        if original_token_prob + random_token_prob > 1:
            raise ValueError("original_token_prob + random_token_prob > 1")
        if max_pred_per_seq < 0:
            raise ValueError("max_pred_per_seq must be >= 0")
        if packing and packing_max_segments < 1:
            raise ValueError("packing_max_segments must be >= 1")
        self.index = index
        self.sampler = sampler
        self.batch_size = batch_size
        self.mask_token_index = mask_token_index
        self.max_pred_per_seq = max_pred_per_seq
        self.masked_lm_prob = masked_lm_prob
        self.vocab_size = vocab_size
        self.original_token_prob = original_token_prob
        self.random_token_prob = random_token_prob
        self._mask_seed = int(seed if seed is not None else sampler.seed)
        self._resident_fi: Optional[int] = None
        self._resident: Optional[Dict[str, np.ndarray]] = None
        self.packing = bool(packing)
        self.packing_max_segments = int(packing_max_segments)
        self.packing_lookahead = max(1, int(packing_lookahead))
        # examples fetched but not yet placed in a row (global indices),
        # and their built rows: each example is gathered and masked once,
        # however many batches it waits through (None: rebuild from the
        # indices, as after a restore)
        self._pending_examples: List[int] = []
        self._pending_built: Optional[Dict[str, np.ndarray]] = None
        self.batch_tap = batch_tap
        self.prefetch_batches = int(prefetch_batches)
        self._assembler = (ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="batch-assemble")
            if self.prefetch_batches > 0 else None)
        self._queue: List[Future] = []
        self._last_state = self._state_snapshot()

    def _ensure_resident(self, fi: int) -> Dict[str, np.ndarray]:
        if fi != self._resident_fi:
            self._resident = self.index.load(fi)
            self._resident_fi = fi
        return self._resident

    def _gather_rows(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        """Rows for (mostly contiguous) global indices, across shard
        boundaries."""
        out: Dict[str, List[np.ndarray]] = {}
        i = 0
        while i < len(indices):
            fi, _ = self.index.locate(int(indices[i]))
            data = self._ensure_resident(fi)
            start, end = self.index.starts[fi], self.index.file_end(fi)
            j = i
            while j < len(indices) and start <= int(indices[j]) < end:
                j += 1
            rows = np.asarray(indices[i:j]) - start
            for k, arr in data.items():
                out.setdefault(k, []).append(arr[rows])
            i = j
        return {k: np.concatenate(v, axis=0) for k, v in out.items()}

    def _build(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        """The masked examples of `indices`, one a row: each example's
        masking draws come from its own generator of (seed, epoch, global
        index), so they do not depend on how examples were grouped."""
        raw = self._gather_rows(indices)
        input_ids = raw["input_ids"].astype(np.int32)
        specials = raw["special_token_positions"]
        rngs = [np.random.default_rng([self._mask_seed, self.sampler.epoch,
                                       int(i)]) for i in indices]
        masked, labels = masking.dynamic_mask_batch(
            input_ids, specials, mask_token_index=self.mask_token_index,
            max_pred_per_seq=self.max_pred_per_seq,
            masked_lm_prob=self.masked_lm_prob,
            draws=masking.per_row_mask_draws(rngs, input_ids.shape[1],
                                             self.vocab_size),
            original_token_prob=self.original_token_prob,
            random_token_prob=self.random_token_prob)
        return {
            "input_ids": masked.astype(np.int32),
            "token_type_ids": masking.segment_ids_from_specials(
                input_ids, specials).astype(np.int32),
            "attention_mask": masking.input_mask_from_specials(
                input_ids, specials).astype(np.int32),
            "masked_lm_labels": labels.astype(np.int32),
            "next_sentence_labels":
                raw["next_sentence_labels"].reshape(-1).astype(np.int32),
        }

    def _assemble_packed(self) -> Optional[Dict[str, np.ndarray]]:
        """One packed batch: top the pending examples up to batch_size x
        packing_lookahead, first-fit their real lengths into batch_size
        rows, pack them; the unplaced stay pending with their built rows.
        At the epoch's end a batch is emitted only if every row holds an
        example (the unpacked loader's dropped partial tail)."""
        if self._pending_built is None and self._pending_examples:
            self._pending_built = self._build(
                np.asarray(self._pending_examples, np.int64))
        target = self.batch_size * self.packing_lookahead
        exhausted = False
        while len(self._pending_examples) < target:
            idx = self.sampler.next_indices(self.batch_size)
            if idx is None:
                exhausted = True
                break
            self._pending_examples.extend(int(i) for i in idx)
            built = self._build(idx)
            self._pending_built = (built if self._pending_built is None else
                                   {k: np.concatenate(
                                       [self._pending_built[k], built[k]])
                                    for k in built})
        if not self._pending_examples:
            return None
        examples = self._pending_built
        seq_len = examples["input_ids"].shape[1]
        bins = packing_lib.first_fit(
            packing_lib.example_lengths(examples["attention_mask"]),
            self.batch_size, seq_len, self.packing_max_segments)
        if exhausted and any(not members for members in bins):
            self._pending_examples, self._pending_built = [], None
            return None
        batch = packing_lib.pack_examples(examples, bins, seq_len,
                                          self.packing_max_segments)
        placed = {i for members in bins for i in members}
        keep = [pos for pos in range(len(self._pending_examples))
                if pos not in placed]
        self._pending_examples = [self._pending_examples[pos]
                                  for pos in keep]
        self._pending_built = ({k: v[keep] for k, v in examples.items()}
                               if keep else None)
        return batch

    def _assemble(self) -> Tuple[Optional[Dict[str, np.ndarray]],
                                 Dict[str, Any]]:
        """(batch or None at epoch end, the loader's state after it)."""
        if self.packing:
            batch = self._assemble_packed()
        else:
            indices = self.sampler.next_indices(self.batch_size)
            batch = None if indices is None else self._build(indices)
        return batch, self._state_snapshot()

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        if self._assembler is None:
            batch, state = self._assemble()
        else:
            if not self._queue:
                self._queue.append(self._assembler.submit(self._assemble))
            head = self._queue.pop(0)
            while len(self._queue) < self.prefetch_batches:
                self._queue.append(self._assembler.submit(self._assemble))
            batch, state = head.result()
        if batch is None:
            self._drain_queue()
            raise StopIteration
        self._last_state = state
        if self.batch_tap is not None:
            self.batch_tap(batch)
        return batch

    def _state_snapshot(self) -> Dict[str, Any]:
        """The sampler's cursor plus, under packing, the pending examples'
        global indices (JSON-serialisable)."""
        state: Dict[str, Any] = self.sampler.state_dict()
        if self.packing:
            state["pending"] = list(self._pending_examples)
        return state

    @property
    def epoch(self) -> int:
        """The epoch being read (the streaming loader's attribute)."""
        return self.sampler.epoch

    def state_dict(self) -> Dict[str, Any]:
        return dict(self._last_state)

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Restore the sampler's cursor (or warn and keep it, see
        HostShardSampler.load_state_dict) and the pending examples, which
        are dropped with a cursor the sampler refused (they belong to the
        old index space); batches assembled ahead are dropped."""
        self._drain_queue()
        self.sampler.load_state_dict(state)
        restored = (state.get("total_size") == self.sampler.total_size
                    and state.get("world_size") == self.sampler.world_size)
        self._pending_examples = ([int(i) for i in state.get("pending", [])]
                                  if restored else [])
        self._pending_built = None
        self._last_state = self._state_snapshot()

    def _drain_queue(self) -> None:
        """Wait out in-flight assemblies; their results (end-of-epoch
        markers, or batches past a reset) are dropped, their errors
        raised."""
        queue, self._queue = self._queue, []
        for f in queue:
            f.result()

    def reset_epoch(self) -> None:
        self._drain_queue()
        self.sampler.reset_epoch()
        self._pending_examples, self._pending_built = [], None
        self._last_state = self._state_snapshot()

    def close(self) -> None:
        if self._assembler is not None:
            self._assembler.shutdown(wait=True, cancel_futures=True)
            self._assembler = None
        self._queue = []


class DevicePrefetcher:
    """Batches staged on the device ahead of the step that reads them
    (JAX: data/sharded.py's DevicePrefetcher).

    Wraps an iterator of numpy batches; `put_fn` turns one into its
    device form (`cuda_put` on a card: a non-blocking copy on a side
    stream). Iteration yields (numpy_batch, device_batch) pairs, so the
    consumer keeps its host-side uses without a device-to-host trip.

    `next()` pulls a batch only when none is staged; `fill()` stages
    batches until `depth` wait. The train loop calls `fill()` after it has
    dispatched a step and before it reads the step's metrics, so the next
    batch's pull, stacking and copy run while the card computes (the loop
    ends each step with a host sync, which would otherwise stage the next
    batch while the card idles). With depth 0 `fill()` does nothing and
    the class is a synchronous map. A consumer that calls `fill()` right
    after each `next()` pulls exactly when JAX's class does.

    `state_dict()` is `state_fn()` (the loader's state) as of the last
    pair yielded, not of the batches staged ahead, so a checkpoint taken
    with batches staged resumes without skipping one. `batch_tap` fires
    at each yield, in dispatch order (the flight recorder's capture
    point). A device batch that carries an `event` (cuda_put's) is waited
    on by the consumer's current stream at its yield, before the step can
    read it."""

    def __init__(self, source, put_fn, depth: int = 1, state_fn=None,
                 batch_tap=None):
        self._source = iter(source)
        self._put = put_fn
        self.depth = max(0, int(depth))
        self._state_fn = state_fn
        self.batch_tap = batch_tap
        self._buf: List[tuple] = []     # (np_batch, staged, state)
        self._last_state = state_fn() if state_fn is not None else None
        self._exhausted = False

    def _pull(self) -> bool:
        if self._exhausted:
            return False
        try:
            batch = next(self._source)
        except StopIteration:
            self._exhausted = True
            return False
        state = self._state_fn() if self._state_fn is not None else None
        self._buf.append((batch, self._put(batch), state))
        return True

    def fill(self) -> None:
        """Stage batches until `depth` wait (or the source ends)."""
        while len(self._buf) < self.depth and self._pull():
            pass

    def __iter__(self):
        return self

    def __next__(self):
        if not self._buf and not self._pull():
            raise StopIteration
        batch, staged, state = self._buf.pop(0)
        self._last_state = state
        if isinstance(staged, StagedBatch):
            staged = staged.ready()
        if self.batch_tap is not None:
            self.batch_tap(batch)
        return batch, staged

    def state_dict(self):
        """Upstream state as of the last yielded pair (None without a
        state_fn)."""
        return self._last_state


class StagedBatch:
    """A batch copied to the card on a side stream (`cuda_put`): its
    device tensors and the event recorded after the copies. The pinned
    host tensors the copies read need no keeping here: PyTorch's caching
    host allocator records an event on the copying stream for a
    non-blocking copy out of pinned memory, and reuses the block only
    once that event has completed."""

    def __init__(self, tensors, event):
        self.tensors, self.event = tensors, event

    def ready(self):
        """The device tensors, ordered after their copy on the caller's
        current stream: the stream waits on the event, and each tensor
        (allocated on the side stream) is recorded as used there, so the
        allocator does not reuse it before the step is done."""
        import torch

        stream = torch.cuda.current_stream()
        stream.wait_event(self.event)
        for t in self.tensors.values():
            t.record_stream(stream)
        return self.tensors


def cuda_put(torch, accum_steps: int, micro: int, device, side_stream):
    """`DevicePrefetcher`'s put on a card: each array reshaped to
    (accum_steps, micro, ...), copied into pinned host memory and from
    there to the card with non_blocking=True on `side_stream`, into
    tensors allocated on that stream; an event recorded after the copies.
    Returns put(numpy_batch) -> StagedBatch."""

    def put(batch_np):
        pinned = {k: torch.from_numpy(np.ascontiguousarray(
            v.reshape(accum_steps, micro, *v.shape[1:]))).pin_memory()
            for k, v in batch_np.items()}
        with torch.cuda.stream(side_stream):
            tensors = {k: v.to(device, non_blocking=True)
                       for k, v in pinned.items()}
            event = torch.cuda.Event()
            event.record(side_stream)
        return StagedBatch(tensors, event)

    return put
