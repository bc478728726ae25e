"""Zero-host device round trip: the encode emits the decode index."""

import numpy as np
import pytest

import jax

from stenos_tpu.engine_jax import roundtrip_device

from conftest import gen_elements


@pytest.mark.parametrize("bpp", [2, 3, 4, 8])
@pytest.mark.parametrize("kind", ["sorted", "random", "same", "rle"])
def test_roundtrip_device(rng, bpp, kind):
    nb, n_sb = 4, 2
    sbytes = nb * 256 * bpp
    raw = np.frombuffer(
        gen_elements(rng, bpp, (n_sb * sbytes) // bpp, kind), np.uint8
    )[: n_sb * sbytes]
    batch = raw.reshape(n_sb, sbytes)
    out, rows, totals = roundtrip_device(jax.numpy.asarray(batch), bpp, 2)
    assert np.asarray(out).tobytes() == raw.tobytes(), (bpp, kind)
    # the emitted rows are also real frame records: host-decode one
    from stenos_tpu import frame as fr

    rec = bytes(np.asarray(rows[0])[: int(totals[0])])
    hdr = bytes([0]) + sbytes.to_bytes(7, "little")
    assert bytes(fr.decompress(hdr + rec, bpp)) == raw[:sbytes].tobytes()
