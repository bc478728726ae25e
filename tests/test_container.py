"""CompressedArray (cvector equivalent) tests, mirroring
tests/test_cvector.cpp behaviors: STL-parity ops, serialize/deserialize
(incl. interop with plain stenos_decompress via the C++ oracle when
present), bulk
apply, metrics."""

import numpy as np
import pytest

import stenos_tpu as st
from stenos_tpu.container import CompressedArray


def test_append_index_roundtrip(rng):
    v = CompressedArray(np.int32, level=2)
    ref = []
    for x in rng.integers(0, 1 << 30, 5000):
        v.append(x)
        ref.append(int(x))
    assert len(v) == 5000
    assert v[0] == ref[0] and v[-1] == ref[-1]
    idx = rng.integers(0, 5000, 200)
    for i in idx:
        assert v[int(i)] == ref[int(i)]
    assert (v.to_numpy() == np.array(ref, np.int32)).all()


def test_extend_slices_setitem(rng):
    data = np.sort(rng.integers(0, 1 << 40, 70001)).astype(np.int64)
    v = CompressedArray(np.int64, block_shift=2, level=1)
    v.extend(data)
    assert (v[100:200] == data[100:200]).all()
    assert (v[::777] == data[::777]).all()
    v[5:10] = np.arange(5, dtype=np.int64)
    data[5:10] = np.arange(5)
    v[70000] = -1
    data[70000] = -1
    assert (v.to_numpy() == data).all()


def test_apply_and_early_stop(rng):
    data = rng.integers(0, 100, 10000).astype(np.int32)
    v = CompressedArray(np.int32)
    v.extend(data)

    def double(chunk):
        chunk *= 2

    visited = v.apply(double, 100, 5000)
    data[100:5000] *= 2
    # apply works at chunk granularity within [start, stop)
    assert (v.to_numpy()[100:5000] == data[100:5000]).all()
    assert visited == 4900

    count = [0]

    def stop_early(chunk):
        count[0] += 1
        return False

    v.apply(stop_early)
    assert count[0] == 1


def test_serialize_interop_with_reference(rng, ref):
    data = np.sort(rng.integers(0, 1 << 30, 33000)).astype(np.uint32)
    v = CompressedArray(np.uint32, block_shift=3, level=2)
    v.extend(data)
    blob = v.serialize()
    # plain stenos_decompress (C++ reference, when present) must accept it
    if ref is not None:
        assert ref.decompress(blob, 4, data.nbytes) == data.tobytes()
    # and our own decompress
    assert st.decompress(blob, 4).tobytes() == data.tobytes()
    # deserialize adopts buckets without decompressing
    w = CompressedArray.deserialize(blob, np.uint32, level=2)
    assert len(w) == len(data)
    assert (w.to_numpy() == data).all()
    assert w[12345] == data[12345]


def test_reference_cvector_frames_decode(rng):
    """A frame produced via our custom-shift compress (what cvector writes)
    round-trips through deserialize."""
    data = rng.integers(0, 1 << 16, 10000).astype(np.uint16)
    frame = st.compress(data.tobytes(), 2, 1, custom_shift=4)
    w = CompressedArray.deserialize(frame, np.uint16)
    assert (w.to_numpy() == data).all()


def test_metrics(rng):
    data = np.sort(rng.integers(0, 1000, 100000)).astype(np.int32)
    v = CompressedArray(np.int32, level=2)
    v.extend(data)
    v.serialize()
    assert v.memory_footprint() > 0
    assert v.current_compression_ratio() > 1.0


def test_eviction_bounded(rng):
    data = rng.integers(0, 1 << 20, 300000).astype(np.int32)
    v = CompressedArray(np.int32, max_raw_buckets=3)
    v.extend(data)
    assert v._raw_count <= 4
    # random access still correct under eviction pressure
    for i in rng.integers(0, len(data), 50):
        assert v[int(i)] == data[int(i)]


def test_eviction_is_lru(rng):
    """Overflow packs the LEAST recently used bucket (the cvector
    free-context-list analog), not the lowest-indexed one."""
    data = rng.integers(0, 1 << 20, 1024 * 64).astype(np.int32)
    v = CompressedArray(np.int32, block_shift=2, max_raw_buckets=3)
    v.extend(data)  # 1024-element chunks -> 64 buckets
    nb = len(v._buckets)
    assert nb >= 8
    # touch buckets 0 and 1 (decompress them), then 2: bucket at the
    # *front* must stay resident (recently used) while older residents go
    _ = v[0]
    _ = v[v.chunk_elems]
    _ = v[2 * v.chunk_elems]
    assert v._buckets[2].raw is not None
    _ = v[3 * v.chunk_elems]  # forces an eviction beyond the limit
    # bucket 0 was the least recently used of the tracked residents
    assert v._buckets[3].raw is not None
    # reads stay correct regardless of residency
    for i in rng.integers(0, len(data), 40):
        assert v[int(i)] == data[int(i)]


def test_insert_erase_resize(rng):
    data = rng.integers(0, 1 << 30, 3000).astype(np.int32)
    v = CompressedArray(np.int32, level=2)
    v.extend(data)
    ref = list(data)

    v.insert(100, 7)
    ref.insert(100, 7)
    v.insert(0, [1, 2, 3])
    ref[0:0] = [1, 2, 3]
    v.insert(len(v), 99)
    ref.append(99)
    assert (v.to_numpy() == np.array(ref, np.int32)).all()

    v.erase(50)
    del ref[50]
    v.erase(10, 700)
    del ref[10:700]
    assert (v.to_numpy() == np.array(ref, np.int32)).all()

    v.resize(len(v) - 500)
    del ref[len(ref) - 500 :]
    v.resize(len(v) + 123, fill=-5)
    ref += [-5] * 123
    assert len(v) == len(ref)
    assert (v.to_numpy() == np.array(ref, np.int32)).all()

    v.pop_back()
    ref.pop()
    assert len(v) == len(ref)
    assert (v.to_numpy() == np.array(ref, np.int32)).all()


def test_const_apply_stays_clean(rng):
    data = np.sort(rng.integers(0, 1 << 30, 4096)).astype(np.int32)
    v = CompressedArray(np.int32, level=1, max_raw_buckets=2)
    v.extend(data)
    blob1 = v.serialize()  # compresses everything; buckets now clean
    acc = []
    n = v.const_apply(lambda c: acc.append(int(c.sum())))
    assert n == len(v)
    assert sum(acc) == int(data.sum())
    # read-only scan must not dirty: all full buckets stay clean
    assert not any(b.dirty for b in v._buckets[:-1])
    # and a read-only view refuses writes
    with pytest.raises((ValueError, RuntimeError)):
        v.const_apply(lambda c: c.__setitem__(0, 1))
    assert v.serialize() == blob1


def test_apply_backward(rng):
    data = rng.integers(0, 100, 1000).astype(np.int32)
    v = CompressedArray(np.int32, level=1)
    v.extend(data)
    seen = []
    v.const_apply_backward(lambda c: seen.extend(c.tolist()))
    assert seen == data[::-1].tolist()
    v.apply_backward(lambda c: c.__iadd__(1))
    assert (v.to_numpy() == data + 1).all()


def test_stream_serialize_roundtrip(rng):
    import io

    data = np.sort(rng.integers(0, 1 << 30, 9000)).astype(np.uint32)
    v = CompressedArray(np.uint32, block_shift=1, level=2)
    v.extend(data)
    buf = io.BytesIO()
    n = v.serialize_to(buf)
    assert n == buf.tell()
    assert buf.getvalue() == v.serialize()
    buf.seek(0)
    w = CompressedArray.deserialize_from(buf, np.uint32)
    assert (w.to_numpy() == data).all()


def test_concurrent_fetch_add_stress(rng):
    """16-thread concurrent read-modify-write over the SAME container
    (test_cvector.cpp:692-726 analog: cvector<atomic<int>> fetch_add)."""
    import threading

    n = 8192
    v = CompressedArray(np.int64, level=1, max_raw_buckets=3)
    v.extend(np.zeros(n, np.int64))
    threads = 16
    adds_per_thread = 4

    def worker(seed):
        r = np.random.default_rng(seed)
        for _ in range(adds_per_thread):
            # whole-array increment via apply (chunk-locked)
            v.apply(lambda c: c.__iadd__(1))
            # plus scattered reads to force pool churn
            for i in r.integers(0, n, 8):
                v[int(i)]

    ts = [threading.Thread(target=worker, args=(s,)) for s in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert (v.to_numpy() == threads * adds_per_thread).all()


def test_strong_debug_flag(rng, monkeypatch):
    monkeypatch.setenv("STENOS_STRONG_DEBUG", "1")
    data = np.sort(rng.integers(0, 1 << 30, 2048)).astype(np.int32)
    v = CompressedArray(np.int32, level=2)
    v.extend(data)
    blob = v.serialize()  # every chunk verify-compressed under the flag
    assert (np.frombuffer(st.decompress(blob, 4), np.int32) == data).all()
