"""Index-emitting XLA encode (encode_records_body) vs the host parser.

The records must be the framed block streams of encode_superblocks_body
(itself bit-exact vs the C++ reference, tests/test_engine_jax.py,
tests/test_frame_parity.py), and the emitted decode index must equal the
plane offsets and codes the native parser reads back from those records.
"""

import numpy as np
import pytest

import jax

from stenos_tpu.engine_jax import (JaxEngine, encode_records_body,
                                   encode_superblocks_body)
from stenos_tpu.native import lib as native

from conftest import gen_elements


@pytest.mark.parametrize("bpp", [2, 3, 4, 8])
@pytest.mark.parametrize("kind", ["sorted", "random", "rle"])
def test_kernel_matches_xla(rng, bpp, kind):
    for nb, level in ((1, 2), (3, 1), (8, 2)):
        sbytes = nb * 256 * bpp
        n_sb = 2
        raw = np.frombuffer(
            gen_elements(rng, bpp, (n_sb * sbytes) // bpp + 1, kind), np.uint8
        )[: n_sb * sbytes]
        batch = raw.reshape(n_sb, sbytes)
        out0, tot0, bs0, fs0 = encode_superblocks_body(
            jax.numpy.asarray(batch), bpp, level)
        out0, tot0 = np.asarray(out0), np.asarray(tot0)
        rows, tot1, bs1, fs1, index = encode_records_body(
            jax.numpy.asarray(batch), bpp, level, with_index=True)
        rows, tot1, index = np.asarray(rows), np.asarray(tot1), \
            np.asarray(index)
        assert (np.asarray(bs1) == np.asarray(bs0)).all()
        assert (np.asarray(fs1) == np.asarray(fs0)).all()
        for i in range(n_sb):
            want = (bytes([1]) + int(tot0[i]).to_bytes(3, "little")
                    + bytes(out0[i][: tot0[i]]))
            rec = bytes(rows[i][: tot1[i]])
            assert want == rec, (bpp, kind, nb, level, i)
            # the index is what the host parser reads from the record
            # (record-relative: +4 header bytes; codes in bits 24-25)
            r = native.parse_rows_batch(rec, bpp, sbytes, [4],
                                        [len(rec) - 4], len(rec) + 512)
            assert not isinstance(r, int), r
            po = r[1][0]
            assert ((index[i] & 0xFFFFFF) == (po & 0xFFFFFF) + 4).all()
            assert ((index[i] >> 24) == (po >> 24)).all(), (bpp, kind, nb)


def test_encode_rounds_match_single_dispatch(rng, monkeypatch):
    """JaxEngine.encode_batch cuts a batch into ROUND_BYTES rounds; the
    per-superblock results must not depend on the cut."""
    import stenos_tpu.engine_jax as ej

    bpp, sb, n_sb = 4, 256 * 4 * 2, 5
    data = np.frombuffer(gen_elements(rng, bpp, n_sb * sb // bpp + 7,
                                      "sorted"), np.uint8)
    one = JaxEngine().encode_batch(data, bpp, sb)
    monkeypatch.setattr(ej, "ROUND_BYTES", 2 * sb)
    cut = JaxEngine().encode_batch(data, bpp, sb)
    assert len(one) == len(cut) == n_sb + 1 and cut[-1] is None
    for a, b in zip(one[:-1], cut[:-1]):
        assert a[1] == b[1]
        assert bytes(a[0][: a[1]]) == bytes(b[0][: b[1]])
        assert (a[2] == b[2]).all() and (a[3] == b[3]).all()
