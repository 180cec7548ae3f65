"""int8 weight-only serving quantization, `--serve_dtype int8`
(counterpart of bert_pytorch_tpu/serving/quantize.py).

The JAX scheme, reproduced exactly: symmetric per-channel int8 of every
flax parameter leaf with ndim >= 2 and at least 64 elements, scale =
max(amax / 127, 1e-12) with amax over every axis but the leaf's last, q =
clip(rint(w / scale), -127, 127), computed host-side in numpy once at
load. The leaves are those of the layout the JAX serving model restores
into, stacked by default whatever the checkpoint's layout: one
`encoder/layers/layer/...` leaf a weight with a leading layer axis. So an
encoder leaf's scale is shared across layers: the QKV kernel (L, E, 3, H,
D) gets one scale per D index (shared across layers, q/k/v and heads), a
dense kernel (L, E, I) one per output channel, and the stacked biases and
LayerNorm parameters ((L, E), (L, 3, H, D)) are quantized too. Outside
the encoder, an embedding table (V, E) gets one scale per E column, the
pooler and head kernels one per output channel, and their biases and the
embedding LayerNorm (1-D leaves) stay in float.

The port holds each quantized tensor in its own layout (a Linear weight
(out, in)) as int8 beside an f32 scale broadcast along the axis the flax
leaf's last axis maps to (`quantize_tree`). `apply_int8` puts them in a
model: each quantized parameter becomes an int8 tensor whose use
dequantizes it, `q.float() * scale` cast to the compute dtype, one weight
at a time inside the forward (and so inside the engine's CUDA graphs),
then the Linear runs on cuBLAS as in bf16 serving. That is the plain
version of a W8A16 matmul that dequantizes in its prologue (ROADMAP queue
B.2 item 4). `decode_delta` is the accuracy gate run_server holds each
task to before serving (`--int8_max_delta`), and `corrupt_scales` the
fault the gate must trip on.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn.utils import parametrize

# leaves smaller than this many elements are never worth quantizing
_MIN_ELEMENTS = 64

_Q_KEY = "q8"
_SCALE_KEY = "scale"

_LAYER = re.compile(r"^(.*\.encoder\.layers\.)(\d+)(\..*)$")


def is_quantized_leaf(x: Any) -> bool:
    """True for the `{"q8": ..., "scale": ...}` dict `quantize_tree`
    substitutes for a weight."""
    return isinstance(x, dict) and set(x) == {_Q_KEY, _SCALE_KEY}


def _flax_view(key: str, shape: Tuple[int, ...], head_dim: int
               ) -> Tuple[Tuple[int, ...], int, int]:
    """(the port tensor's view whose `channel` axis is the flax leaf's
    last axis, that axis, the flax leaf's ndim without a layer axis)."""
    if key.endswith("attention.qkv.weight"):      # (3HD, E) <- (E, 3, H, D)
        return (shape[0] // head_dim, head_dim, shape[1]), 1, 4
    if key.endswith("attention.qkv.bias"):        # (3HD,) <- (3, H, D)
        return (shape[0] // head_dim, head_dim), 1, 3
    if key.endswith("attention.output.weight"):   # (E, HD) <- (H, D, E)
        return tuple(shape), 0, 3
    if key.endswith("embeddings.weight"):         # tables: as flax holds them
        return tuple(shape), len(shape) - 1, len(shape)
    # Linear weights (out, in) <- kernels (in, out); biases, LayerNorm
    return tuple(shape), 0, len(shape)


def quantize_tree(state: Dict[str, torch.Tensor], head_dim: int,
                  stacked: bool = True) -> Tuple[Dict[str, Any],
                                                 Dict[str, int]]:
    """A served model's f32 state_dict -> (the quantized state, stats).

    Each tensor of a leaf the JAX scheme quantizes becomes {"q8": int8
    tensor in the port's layout, "scale": f32 tensor broadcastable
    against it}; the others pass through as f32. The encoder's layers
    group into the JAX serving model's stacked leaves unless `stacked` is
    False (a model config with `stacked_params: false`), where each
    layer's leaf stands alone. stats counts the leaves and the resident
    bytes before and after."""
    arrays = {k: np.asarray(v.detach().cpu().float().numpy())
              for k, v in state.items()}
    groups: Dict[str, list] = {}
    for key in arrays:
        m = _LAYER.match(key)
        group = (m.group(1) + "*" + m.group(3)) if (m and stacked) else key
        groups.setdefault(group, []).append(key)
    out: Dict[str, Any] = {}
    stats = {"quantized_leaves": 0, "passthrough_leaves": 0,
             "bytes_before": 0, "bytes_after": 0}
    for group, keys in groups.items():
        w0 = arrays[keys[0]]
        view, axis, flax_ndim = _flax_view(keys[0], w0.shape, head_dim)
        layered = len(keys) > 1 or group != keys[0]
        if layered:
            flax_ndim += 1
        for k in keys:
            stats["bytes_before"] += arrays[k].nbytes
        if flax_ndim < 2 or w0.size * len(keys) < _MIN_ELEMENTS:
            for k in keys:
                out[k] = torch.from_numpy(arrays[k])
                stats["bytes_after"] += arrays[k].nbytes
            stats["passthrough_leaves"] += 1
            continue
        reduce_axes = tuple(i for i in range(len(view)) if i != axis)
        amax = np.max(np.stack([
            np.max(np.abs(arrays[k].reshape(view)), axis=reduce_axes,
                   keepdims=True) for k in keys]), axis=0)
        scale = np.maximum(amax / 127.0, 1e-12).astype(np.float32)
        for k in keys:
            w = arrays[k]
            q = np.clip(np.rint(w.reshape(view) / scale), -127,
                        127).astype(np.int8)
            s = _port_scale(scale, view, axis, w.shape)
            out[k] = {_Q_KEY: torch.from_numpy(q.reshape(w.shape)),
                      _SCALE_KEY: torch.from_numpy(s)}
            stats["bytes_after"] += q.nbytes + s.nbytes
        stats["quantized_leaves"] += 1
    return out, stats


def _port_scale(scale: np.ndarray, view: Tuple[int, ...], axis: int,
                shape: Tuple[int, ...]) -> np.ndarray:
    """The keepdims scale of a (view, axis) reduction as an f32 array
    broadcastable against the port tensor of `shape`: a column (rows, 1)
    for a Linear weight, a row (1, E) for a table, a vector for a 1-D
    tensor."""
    if len(shape) == 1:
        full = np.broadcast_to(scale, view)           # (3H, D) or (n,)
        return np.array(full.reshape(shape), np.float32)
    if axis == len(view) - 1:                          # tables (V, E)
        return np.array(scale.reshape(1, -1), np.float32)
    # the output axis: (out, 1), the QKV weight's D-scale tiled over 3H
    full = np.broadcast_to(scale, view[:axis + 1] + (1,) * (len(view)
                                                            - axis - 1))
    return np.array(full.reshape(shape[0], 1), np.float32)


def corrupt_scales(qstate: Dict[str, Any],
                   factor: float = 37.0) -> Dict[str, Any]:
    """Break the first quantized tensor's scales (times `factor`): the
    accuracy gate must trip on the result."""
    out = dict(qstate)
    for key, leaf in qstate.items():
        if is_quantized_leaf(leaf):
            out[key] = {_Q_KEY: leaf[_Q_KEY],
                        _SCALE_KEY: leaf[_SCALE_KEY] * factor}
            return out
    raise ValueError("corrupt_scales: no quantized leaf found")


class Dequantize(nn.Module):
    """The parametrization of an int8 weight: q.float() * scale, cast to
    the compute dtype, evaluated at each use."""

    def __init__(self, scale: torch.Tensor, dtype: torch.dtype):
        super().__init__()
        self.register_buffer("scale", scale)
        self.dtype = dtype

    def forward(self, q: torch.Tensor) -> torch.Tensor:
        return (q.float() * self.scale).to(self.dtype)


def apply_int8(model: nn.Module, qstate: Dict[str, Any],
               dtype: torch.dtype) -> nn.Module:
    """Load `qstate` (quantize_tree) into `model` strictly: float tensors
    are copied into their parameters; each quantized one replaces its
    parameter by its int8 tensor, dequantized at use into `dtype`."""
    params = dict(model.named_parameters())
    if set(params) != set(qstate):
        raise KeyError(f"int8 state and model differ: missing "
                       f"{sorted(set(params) - set(qstate))}, unexpected "
                       f"{sorted(set(qstate) - set(params))}")
    for key, leaf in qstate.items():
        prefix, _, name = key.rpartition(".")
        mod = model.get_submodule(prefix)
        p = params[key]
        if not is_quantized_leaf(leaf):
            with torch.no_grad():
                p.copy_(leaf)
            continue
        if tuple(leaf[_Q_KEY].shape) != tuple(p.shape):
            raise ValueError(f"{key}: int8 shape {tuple(leaf[_Q_KEY].shape)}"
                             f" != {tuple(p.shape)}")
        del mod._parameters[name]  # noqa: SLF001
        mod.register_parameter(name, nn.Parameter(
            leaf[_Q_KEY].to(p.device), requires_grad=False))
        parametrize.register_parametrization(
            mod, name, Dequantize(leaf[_SCALE_KEY].to(p.device), dtype),
            unsafe=True)
    return model


def resident_bytes(model: nn.Module) -> int:
    """Bytes of a model's parameters and buffers as they lie (int8
    weights, their scales, bf16 or f32 copies)."""
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))


def probe_batch(batch_rows: int, bucket: int, vocab_size: int,
                max_segments: int = 2, seed: int = 0) -> Dict[str, np.ndarray]:
    """The gate's deterministic packed batch: every row filled by
    `max_segments` segments of random in-vocab tokens (the JAX draw)."""
    from bert_pytorch_tpu_torch.serving.engine import zero_batch

    rng = np.random.RandomState(seed)
    batch = zero_batch(batch_rows, bucket)
    seg_len = bucket // max_segments
    for row in range(batch_rows):
        for seg in range(max_segments):
            lo, hi = seg * seg_len, (seg + 1) * seg_len
            batch["input_ids"][row, lo:hi] = rng.randint(
                1, max(2, vocab_size), size=hi - lo)
            batch["attention_mask"][row, lo:hi] = 1
            batch["segment_ids"][row, lo:hi] = seg + 1
            batch["position_ids"][row, lo:hi] = np.arange(hi - lo)
    return batch


def decode_delta(ref_forward: Callable, q_forward: Callable,
                 batch: Dict[str, np.ndarray],
                 device: Optional[torch.device] = None) -> Dict[str, float]:
    """The quantized forward against the f32 reference on one batch (each
    forward takes a dict of (B, S) int32 tensors on `device`):
    {"max_abs_delta", "rel_delta": max_abs_delta over the reference's
    largest |output| (+1e-9), "argmax_agreement": the share of positions
    whose argmax over the trailing axis agrees (1.0 when no output has a
    trailing axis wider than 1)}. rel_delta is what the gate holds."""
    tb = {k: torch.from_numpy(np.ascontiguousarray(v, np.int32)).to(device)
          for k, v in batch.items()}
    with torch.inference_mode():
        ref = [t.float().cpu().numpy() for t in _leaves(ref_forward(tb))]
        got = [t.float().cpu().numpy() for t in _leaves(q_forward(tb))]
    if len(ref) != len(got):
        raise ValueError("reference/quantized outputs differ in structure")
    max_abs = ref_mag = 0.0
    agree_n = agree_total = 0
    for a, b in zip(ref, got):
        if a.shape != b.shape:
            raise ValueError(f"output shape mismatch {a.shape} vs {b.shape}")
        max_abs = max(max_abs, float(np.max(np.abs(a - b))) if a.size
                      else 0.0)
        ref_mag = max(ref_mag, float(np.max(np.abs(a))) if a.size else 0.0)
        if a.ndim >= 1 and a.shape[-1] > 1:
            agree_n += int(np.sum(np.argmax(a, -1) == np.argmax(b, -1)))
            agree_total += int(np.prod(a.shape[:-1]))
    return {"max_abs_delta": max_abs,
            "rel_delta": max_abs / (ref_mag + 1e-9),
            "argmax_agreement": (agree_n / agree_total
                                 if agree_total else 1.0)}


def _leaves(out) -> Tuple[torch.Tensor, ...]:
    return out if isinstance(out, tuple) else (out,)
