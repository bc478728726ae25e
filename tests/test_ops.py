"""Unit tests for the core vector primitives: log-shift compaction/expansion
(ops/compact.py), fill-left propagation, bit packing, filters."""

import numpy as np
import pytest

from stenos_tpu.ops.compact import compact, expand, fill_left
from stenos_tpu.ops.bitpack import pack16, unpack16
from stenos_tpu.ops.delta import delta_np, delta_inv_np
from stenos_tpu.ops.shuffle import shuffle_np, unshuffle_np


def test_compact_fuzz(rng):
    for _ in range(100):
        B, W = int(rng.integers(1, 5)), int(rng.integers(2, 400))
        vals = rng.integers(0, 256, (B, W))
        valid = rng.integers(0, 2, (B, W)).astype(bool)
        out, cnt = compact(np, vals, valid)
        for b in range(B):
            ref = vals[b][valid[b]]
            assert cnt[b] == len(ref)
            assert (out[b][: len(ref)] == ref).all()
            assert (out[b][len(ref):] == 0).all()


def test_expand_fuzz(rng):
    for _ in range(100):
        B = int(rng.integers(1, 4))
        n_seg = int(rng.integers(1, 14))
        W = int(rng.integers(4, 40))
        sizes = rng.integers(0, W + 1, (B, n_seg))
        starts = np.cumsum(sizes, axis=-1) - sizes
        L = max(int(starts[:, -1].max() + sizes[:, -1].max()), 1)
        stream = rng.integers(1, 256, (B, L))
        win = expand(np, stream, starts.astype(np.int64), W)
        for b in range(B):
            for s in range(n_seg):
                st = starts[b, s]
                en = starts[b, s + 1] if s + 1 < n_seg else min(
                    st + sizes[b, s], L)
                take = max(0, min(en - st, W, L - st))
                assert (win[b, s, :take] == stream[b, st : st + take]).all()


def test_fill_left():
    v = np.array([[0, 5, 0, 0, 7, 0, 0, 0, 9, 0, 0, 0, 0, 0, 1, 0]])
    h = v != 0
    out, oh = fill_left(np, v, h)
    assert (out[0] == [0, 5, 5, 5, 7, 7, 7, 7, 9, 9, 9, 9, 9, 9, 1, 1]).all()
    assert not oh[0, 0]
    # leading empty lanes must not pick up wrap-around garbage
    v2 = np.array([[0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 42]])
    out2, oh2 = fill_left(np, v2, v2 != 0)
    assert (out2[0, :15] == 0).all() and not oh2[0, 0]


def test_bitpack_roundtrip(rng):
    for b in range(1, 7):
        vals = rng.integers(0, 1 << b, (100, 16)).astype(np.int32)
        packed = pack16(np, vals, b)
        assert packed.shape[-1] == 2 * b
        un = unpack16(np, packed, b)
        assert (un == vals).all()


def test_delta_roundtrip(rng):
    for n in [0, 1, 100, 2048, 2049, 10000, 100003]:
        src = rng.integers(0, 256, n).astype(np.uint8)
        assert (delta_inv_np(delta_np(src)) == src).all()


def test_shuffle_roundtrip(rng):
    for bpp in [1, 2, 3, 4, 7, 16]:
        for n in [0, bpp, 256 * bpp, 1000, 1001]:
            src = rng.integers(0, 256, n).astype(np.uint8)
            assert (unshuffle_np(shuffle_np(src, bpp), bpp) == src).all()
