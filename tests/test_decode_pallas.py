"""XLA slab decoders (explicit and derive index) + batched C parser.

Inputs come from the batched native row parser (stn_parse_rows_batch); the
decoders' output must reproduce the original bytes for frames produced by
the (reference-bit-exact) host compressor.
"""

import numpy as np
import pytest

import jax

from stenos_tpu import frame as fr
from stenos_tpu.engine_jax import decode_slabs_derive_jit, decode_slabs_jit
from stenos_tpu.native import lib as native

from conftest import gen_elements


@pytest.mark.parametrize("bpp", [2, 3, 4, 8])
@pytest.mark.parametrize("kind", ["sorted", "random", "same", "rle"])
def test_decode_kernel_roundtrip(rng, bpp, kind):
    for nb, level in ((1, 2), (3, 1), (8, 2)):
        sbytes = nb * 256 * bpp
        raw = np.frombuffer(
            gen_elements(rng, bpp, sbytes // bpp, kind), np.uint8)[:sbytes]
        stream = fr.compress(raw, bpp, level, engine=None)
        if stream[8] != 1:  # not method BLOCK: nothing to test here
            continue
        csize = int.from_bytes(stream[9:12], "little")
        row_bytes = -(-(csize + 512) // 128) * 128
        r = native.parse_rows_batch(stream, bpp, sbytes, [12], [csize],
                                    row_bytes)
        assert not isinstance(r, int), r
        vbufs, plane_off, rowtab, _vlens = r
        got = np.asarray(decode_slabs_jit(
            jax.numpy.asarray(vbufs), jax.numpy.asarray(plane_off),
            jax.numpy.asarray(rowtab), bpp, nb))
        assert got.reshape(-1).tobytes() == raw.tobytes(), (bpp, kind, nb,
                                                            level)


def test_batch_parser_matches_single(rng):
    bpp, nb, n_sb = 4, 8, 3
    sbytes = nb * 256 * bpp
    raw = np.frombuffer(
        gen_elements(rng, bpp, n_sb * sbytes // bpp, "sorted"), np.uint8
    )[: n_sb * sbytes]
    # custom blocksize shift -> 3 superblocks of 8 blocks (12-byte header)
    stream = fr.compress(raw, bpp, 1, engine=None, custom_shift=3)
    offs, csizes, p = [], [], 12
    for _ in range(n_sb):
        assert stream[p] == 1
        c = int.from_bytes(stream[p + 1 : p + 4], "little")
        offs.append(p + 4)
        csizes.append(c)
        p += 4 + c
    row_bytes = -(-(max(csizes) + 512) // 128) * 128
    r = native.parse_rows_batch(stream, bpp, sbytes, offs, csizes, row_bytes)
    assert not isinstance(r, int)
    vbufs, plane_off, rowtab, _vlens = r
    for i in range(n_sb):
        payload = stream[offs[i] : offs[i] + csizes[i]]
        vb1, po1, rel1, rh1, rm1, tail, _ = native.parse_rows(
            payload, bpp, sbytes)
        assert len(tail) == 0
        assert bytes(vbufs[i][: len(vb1)]) == bytes(vb1)
        assert ((plane_off[i] & 0xFFFFFF) == po1).all()
        rt1 = (rel1.astype(np.int32) | (rh1.astype(np.int32) << 10)
               | (rm1.astype(np.int32) << 14)).T
        assert (rowtab[i] == rt1).all()


@pytest.mark.parametrize("bpp", [2, 3, 4, 8])
@pytest.mark.parametrize("kind", ["sorted", "random", "same", "rle",
                                  "smallrange"])
def test_decode_kernel_derive_index(rng, bpp, kind):
    """Derive-index mode: the decoder reconstructs row records from the
    stream's own header bytes; only plane offsets (+2-bit codes) are fed."""
    for nb, level in ((1, 2), (3, 1), (8, 2)):
        sbytes = nb * 256 * bpp
        raw = np.frombuffer(
            gen_elements(rng, bpp, sbytes // bpp, kind), np.uint8)[:sbytes]
        stream = fr.compress(raw, bpp, level, engine=None)
        if stream[8] != 1:  # not method BLOCK: nothing to test here
            continue
        csize = int.from_bytes(stream[9:12], "little")
        row_bytes = -(-(csize + 512) // 128) * 128
        r = native.parse_rows_batch(stream, bpp, sbytes, [12], [csize],
                                    row_bytes)
        assert not isinstance(r, int), r
        vbufs, plane_off, _rowtab, _vlens = r
        got = np.asarray(decode_slabs_derive_jit(
            jax.numpy.asarray(vbufs), jax.numpy.asarray(plane_off), bpp, nb))
        assert got.reshape(-1).tobytes() == raw.tobytes(), (bpp, kind, nb,
                                                            level)


def test_decode_kernel_derive_lz(rng):
    """Derive mode over a stream with inlined LZ blocks (code-1 planes)."""
    from test_lz_adoption import lz_trigger_bytes

    bpp, nb = 4, 2
    sbytes = nb * 256 * bpp
    raw = lz_trigger_bytes(rng, 1, sbytes)
    stream = fr.compress(raw, bpp, 1, engine=None,
                         custom_shift=(nb).bit_length() - 1)
    assert stream[12] == 1
    csize = int.from_bytes(stream[13:16], "little")
    row_bytes = -(-(csize + sbytes + 512) // 128) * 128
    r = native.parse_rows_batch(stream, bpp, sbytes, [16], [csize],
                                row_bytes)
    assert not isinstance(r, int), r
    vbufs, plane_off, _rowtab, vlens = r
    got = np.asarray(decode_slabs_derive_jit(
        jax.numpy.asarray(vbufs), jax.numpy.asarray(plane_off), bpp, nb))
    assert got.reshape(-1).tobytes() == raw.tobytes()
