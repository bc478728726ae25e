"""Device-resident compressed array (cvector device mode)."""

import numpy as np
import pytest

import stenos_tpu as st
from stenos_tpu.device_container import DeviceCompressedArray

from conftest import gen_elements


@pytest.mark.parametrize("kind", ["sorted", "random", "rle"])
def test_roundtrip_and_access(rng, kind):
    # small slabs (nb=4 blocks) keep interpret-free CPU XLA fast
    a = np.frombuffer(gen_elements(rng, 4, 3000, kind), "<u4")
    arr = DeviceCompressedArray.from_array(a, slab_elems=1024)
    assert len(arr) == len(a)
    assert (arr.to_array() == a).all()
    assert arr[0] == a[0]
    assert arr[len(a) - 1] == a[-1]
    assert arr[17] == a[17]
    assert (arr[100:200] == a[100:200]).all()
    assert arr.memory_footprint() > 0
    # slab() returns the raw bytes of one slab
    got = np.asarray(arr.slab(0)).view("<u4")
    assert (got == a[:1024]).all()


def test_serialize_is_standard_frame(rng):
    a = np.frombuffer(gen_elements(rng, 4, 5000, "sorted"), "<u4")
    arr = DeviceCompressedArray.from_array(a, slab_elems=1024)
    frame = arr.serialize()
    back = st.decompress(frame, 4)
    assert bytes(back) == a.tobytes()


def test_deserialize_adopts_foreign_frame(rng):
    a = np.frombuffer(gen_elements(rng, 4, 4096, "sorted"), "<u4")
    # a frame produced by the plain compressor with a custom blocksize
    from stenos_tpu import frame as fr

    frame = fr.compress(a.view(np.uint8), 4, 1, custom_shift=2)
    arr = DeviceCompressedArray.deserialize(frame, "<u4")
    assert (arr.to_array() == a).all()
    # and round again
    assert bytes(st.decompress(arr.serialize(), 4)) == a.tobytes()


def test_compression_happens(rng):
    # default (128-block) slabs amortize the bucket padding; the index costs
    # a fixed 18.75% of raw (see the class docstring)
    a = np.frombuffer(gen_elements(rng, 4, 96 * 1024, "smallrange"), "<u4")
    arr = DeviceCompressedArray.from_array(a)
    assert arr.current_compression_ratio() > 2.0


def test_entropy_container_roundtrip(rng):
    """Packed device entropy stage: records huffman-coded in HBM, reads
    decode entropy -> block codec fully on device (VERDICT r1 item 2's
    container clause)."""
    from stenos_tpu.device_container import DeviceCompressedArray

    probs = 1.0 / np.arange(1, 31)
    probs /= probs.sum()
    d = rng.choice(np.arange(97, 127, dtype=np.uint8), size=800_000, p=probs)
    a = DeviceCompressedArray.from_array(d, entropy=True)
    p = DeviceCompressedArray.from_array(d)
    assert a._entropy is not None
    assert a.memory_footprint() < p.memory_footprint()
    assert np.array_equal(a.to_array(), d)
    # slab reads slice the covering entropy blocks
    assert np.array_equal(
        np.asarray(a.slab(2)).view(np.uint8),
        d[2 * a.slab_bytes : 3 * a.slab_bytes])
    assert int(a[123_456]) == int(d[123_456])
    # serialize -> a plain stenos frame carrying the block-codec stage
    blob = a.serialize()
    import stenos_tpu as st

    assert st.decompress(blob, 1).tobytes() == d.tobytes()
    back = DeviceCompressedArray.deserialize(blob, np.uint8)
    assert np.array_equal(back.to_array(), d)


def test_entropy_container_bails_when_unprofitable(rng):
    """The stage must switch itself off when huffman can't beat the plain
    record store (block-codec residuals are usually near-uniform)."""
    from stenos_tpu.device_container import DeviceCompressedArray

    d = np.cumsum(rng.normal(0, 80, 200_000)).astype("<i4")
    a = DeviceCompressedArray.from_array(d, entropy=True)
    assert a._entropy is None
    assert np.array_equal(a.to_array(), d)
