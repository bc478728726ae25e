"""LZ-escape (marker 253) handling across the virtual-stream consumers.

The parser inlines BLOCK_LZ/BLOCK_COPY blocks expanded to the full 256*bpp
shuffled planes, so the VIRTUAL stream can be longer than the compressed
record (vlens > csize). These tests pin the consumers that must honor that:
device_container adoption + re-serialization, and the explicit-index slab
decoder. Reference behavior: block_compress.h:1209-1223 (LZ
escape), stenos.cpp:681-753 (decode dispatch).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from stenos_tpu import frame as fr
from stenos_tpu.device_container import DeviceCompressedArray
from stenos_tpu.native import lib as native

pytestmark = pytest.mark.skipif(native is None, reason="no native runtime")


def lz_trigger_bytes(rng, n_sb: int, sb: int) -> np.ndarray:
    """Plane-hostile but LZ-friendly: random u32 pattern tiled with period
    64 elements. Per-plane rows are high-entropy (fsize*3 > block_size) but
    every value repeats at distance 64, so lz_compress wins."""
    pat = rng.integers(0, 1 << 32, 64, dtype=np.uint64).astype(np.uint32)
    nelem = n_sb * sb // 4
    return np.tile(pat, nelem // 64)[:nelem].view(np.uint8)


def parse_frame_records(frame: bytes, bpp: int):
    dsize, sb, pos = fr.get_info(frame, bpp)
    offs, csizes = [], []
    p = pos
    for _ in range(dsize // sb):
        assert frame[p] == 1, "expected method BLOCK"
        c = int.from_bytes(frame[p + 1 : p + 4], "little")
        offs.append(p + 4)
        csizes.append(c)
        p += 4 + c
    return sb, offs, csizes


def test_trigger_produces_lz_blocks(rng):
    raw = lz_trigger_bytes(rng, 2, 131072)
    frame = fr.compress(raw, 4, 1, engine=None)
    sb, offs, csizes = parse_frame_records(frame, 4)
    r = native.parse_rows_batch(frame, 4, sb, offs, csizes,
                                -(-(max(csizes) + 512) // 128) * 128)
    assert not isinstance(r, int), r
    _, _, _, vlens = r
    # the whole point: LZ inlining makes the virtual stream LONGER than
    # the record; if this stops triggering, the generator needs retuning
    assert (np.asarray(vlens) > np.asarray(csizes)).any()
    assert np.frombuffer(fr.decompress(frame, 4), np.uint8).tobytes() \
        == raw.tobytes()


def test_device_container_adopts_lz_frames(rng):
    raw = lz_trigger_bytes(rng, 3, 131072)
    frame = fr.compress(raw, 4, 1, engine=None)
    arr = DeviceCompressedArray.deserialize(frame, np.uint32)
    got = arr.to_array().view(np.uint8)
    assert got.tobytes() == raw.tobytes()
    # serialize() must re-emit a VALID frame (the original records, not the
    # expanded virtual stream)
    blob = arr.serialize()
    assert np.frombuffer(fr.decompress(blob, 4), np.uint8).tobytes() \
        == raw.tobytes()
    # and adopt-again round-trips
    arr2 = DeviceCompressedArray.deserialize(blob, np.uint32)
    assert arr2.to_array().view(np.uint8).tobytes() == raw.tobytes()


def test_reslab_split_honors_virtual_length(rng):
    """LZ blocks are inlined expanded by the parser, so the virtual stream
    is longer than the record (vlens > csize): the explicit decoder must
    read the whole virtual stream, not csize bytes of it."""
    from stenos_tpu.engine_jax import decode_slabs_jit

    bpp, shift = 4, 2
    sb = 256 * bpp << shift  # nb = 4
    nb = sb // (256 * bpp)
    raw = lz_trigger_bytes(rng, 2, sb)
    frame = fr.compress(raw, bpp, 1, engine=None, custom_shift=shift)
    sb2, offs, csizes = parse_frame_records(frame, bpp)
    assert sb2 == sb
    r = native.parse_rows_batch(frame, bpp, sb, offs, csizes,
                                -(-(max(csizes) + sb + 512) // 128) * 128)
    assert not isinstance(r, int), r
    vbufs, po, rt, vlens = r
    assert (np.asarray(vlens) > np.asarray(csizes)).any()
    got = np.asarray(decode_slabs_jit(jnp.asarray(vbufs), jnp.asarray(po),
                                      jnp.asarray(rt), bpp, nb))
    assert got.reshape(-1).tobytes() == raw.tobytes()
