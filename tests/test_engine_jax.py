"""Device (JAX) engine must produce byte-identical frames to the host path
(which is itself bit-exact vs the C++ reference), and the device decoder
must round-trip every method.

Kept deliberately small: each distinct (superblock shape, bpp) pair costs an
XLA CPU compile of the full log-shift graphs. The exhaustive distribution
grid runs against the host engine in test_frame_parity.py; here we pin the
device paths on representative shapes covering every construct (bitpack,
delta, RLE rows, NORMAL_RLE mins, ALL_SAME/ALL_RAW planes, LZ blocks,
partial tails, multi-superblock frames).
"""

import numpy as np
import pytest

import stenos_tpu as st
from stenos_tpu.engine_jax import JaxEngine, decompress_frame_batched
from conftest import gen_elements


CASES = [
    ("sorted", 4, 70001),     # multi-superblock + partial tail
    ("random", 4, 40000),     # LZ escapes + ALL_RAW planes
    ("rle", 8, 5000),         # RLE rows + NORMAL_RLE mins
    ("smallrange", 2, 33000), # low bit widths
    ("same", 1, 5000),        # ALL_SAME planes, bpp 1
]


@pytest.mark.parametrize("kind,bpp,ne", CASES)
def test_jax_engine_roundtrip_and_parity(rng, kind, bpp, ne):
    eng = JaxEngine()
    data = gen_elements(rng, bpp, ne, kind)
    for level in [1, 2]:
        host_frame = st.compress(data, bpp, level)
        dev_frame = st.compress(data, bpp, level, engine=eng)
        assert dev_frame == host_frame, (kind, bpp, ne, level)
        assert st.decompress(dev_frame, bpp, engine=eng).tobytes() == data


def test_batched_frame_decode(rng):
    data = gen_elements(rng, 4, 131072 // 4 * 6, "sorted")
    frame = st.compress(data, 4, 1)
    out = decompress_frame_batched(frame, 4)
    assert out is not None and out.tobytes() == data


def test_shape_bucketed_batch_identical(rng, monkeypatch):
    """Frames must not depend on how JaxEngine.encode_batch cuts the input
    into ROUND_BYTES dispatch rounds (bounded device memory and compiled
    shapes): a tiny round size gives the one-round frame byte for byte."""
    import stenos_tpu as st
    import stenos_tpu.engine_jax as ej
    from stenos_tpu.engine_jax import JaxEngine

    from conftest import gen_elements

    data = gen_elements(rng, 4, 700_000, "sorted")
    eng = JaxEngine()
    f0 = st.compress(np.frombuffer(data, np.uint8), 4, 2, engine=eng)
    monkeypatch.setattr(ej, "ROUND_BYTES", 3 * 131072)
    f1 = st.compress(np.frombuffer(data, np.uint8), 4, 2, engine=eng)
    assert f0 == f1
    assert st.decompress(f1, 4).tobytes() == data
