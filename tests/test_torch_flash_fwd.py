"""The tile geometry of the port's bf16 flash forward
(ops/kernels/csrc/flash_attention_fwd.cu), on the CPU at small shapes:

- its dropout mask, assembled from its tiles (64 queries of a warpgroup or
  128 of a work item, by 128 keys), equals `flash_keep_all` and the
  Pallas `_keep_mask` bit for bit;
- the hash split the kernel evaluates (a row term once a row, a column
  term once a key, one xor to mix them) gives that mask bit for bit;
- chip_smoke.py's `expected_skips` at the forward's (64, 128) tile, which
  the card's skip count is held to, equals a brute-force count of the
  segment-range rule on `packed_segments`, and no skipped tile pair holds
  a (query, key) pair the packed mask allows.
"""

import importlib
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads  # noqa: E402,F401  (the cores shared among xdist workers)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from bert_pytorch_tpu_torch.ops import attention as tatt  # noqa: E402

jfa = importlib.import_module("bert_pytorch_tpu.ops.pallas.flash_attention")

FWD_TILES = [(64, 128), (128, 128)]
SEEDS = [0, -1640531527, 2 ** 31 - 1]


@pytest.mark.parametrize("tile", FWD_TILES)
@pytest.mark.parametrize("seed", SEEDS)
def test_keep_mask_from_forward_tiles_is_bit_equal(tile, seed):
    rows, keys = tile
    batch, heads, seq, rate = 2, 2, 256, 0.1
    full = tatt.flash_keep_all(seed, batch, heads, seq, rate).numpy()
    for bh in range(batch * heads):
        got = np.zeros((seq, seq), bool)
        for q0 in range(0, seq, rows):
            for k0 in range(0, seq, keys):
                t = tatt.flash_keep_mask(seed, bh, q0, k0, rows, keys,
                                         rate).numpy()
                want = np.asarray(jfa._keep_mask(jnp.int32(seed), bh, q0, k0,
                                                 rows, keys, rate))
                np.testing.assert_array_equal(t, want,
                                              err_msg=f"{bh} {q0} {k0}")
                got[q0:q0 + rows, k0:k0 + keys] = t
        np.testing.assert_array_equal(got, full[bh // heads, bh % heads])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_split_hash_terms_give_the_keep_mask(seed, rate):
    """The kernel's mix: r = row * 0x9E3779B1 ^ seed_bh and c = key *
    0x85EBCA77, each folded by its own x ^= x >> 16 (the first xorshift
    distributes over xor), then one xor and the rest of the hash."""
    bh, seq = 7, 384
    seed_bh = np.uint32((seed & 0xFFFFFFFF) + bh * 0xC2B2AE3D & 0xFFFFFFFF)
    pos = np.arange(seq, dtype=np.uint32)
    with np.errstate(over="ignore"):
        r = (pos * np.uint32(0x9E3779B1)) ^ seed_bh
        c = pos * np.uint32(0x85EBCA77)
        r ^= r >> np.uint32(16)
        c ^= c >> np.uint32(16)
        x = r[:, None] ^ c[None, :]
        x = x * np.uint32(0x7FEB352D)
        x ^= x >> np.uint32(15)
        x = x * np.uint32(0x846CA68B)
    keep_min = np.uint32(tatt.flash_keep_threshold(rate) << 9)
    want = tatt.flash_keep_mask(seed, bh, 0, 0, seq, seq, rate).numpy()
    np.testing.assert_array_equal(x >= keep_min, want)


def _brute_skips(seg, rows, keys):
    """(query tile, key tile) pairs per head whose [min non-pad, max]
    segment ranges do not meet, by a loop over every position, and the
    pairs the packed mask allows inside skipped tiles (must be none)."""
    skipped = allowed_inside = 0
    batch, seq = seg.shape
    for b in range(batch):
        s = [int(v) for v in seg[b]]
        for q0 in range(0, seq, rows):
            qs = s[q0:q0 + rows]
            q_lo = min([v for v in qs if v > 0], default=1 << 30)
            q_hi = max(qs)
            for k0 in range(0, seq, keys):
                ks = s[k0:k0 + keys]
                k_lo = min([v for v in ks if v > 0], default=1 << 30)
                k_hi = max(ks)
                meet = q_hi > 0 and k_hi > 0 and q_hi >= k_lo and k_hi >= q_lo
                if not meet:
                    skipped += 1
                    allowed_inside += sum(1 for a in qs for k in ks
                                          if a > 0 and a == k)
    return skipped, allowed_inside


@pytest.mark.parametrize("batch,seq,seed", [(8, 512, 0), (8, 512, 1),
                                            (4, 1024, 0)])
def test_expected_skips_at_the_forward_tile(batch, seq, seed):
    seg = chip_smoke.packed_segments(np, np.random.RandomState(seed), batch,
                                     seq)
    skipped, allowed_inside = _brute_skips(seg, 64, 128)
    assert skipped > 0 and allowed_inside == 0
    for heads in (1, 16):
        assert chip_smoke.expected_skips(np, seg, 64, 128, heads) == \
            skipped * heads
