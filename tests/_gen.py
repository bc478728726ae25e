"""Test data generators (no JAX import: tools/gen_parity_digests.py uses
them too)."""

import numpy as np


def gen_elements(rng, bpp, nelem, kind):
    """Data generators mirroring tests_comp_decomp.cpp:37-85 plus extras."""
    hi = 1 << min(8 * bpp - 1, 60)
    if kind == "sorted":
        a = np.sort(rng.integers(0, hi, nelem))
    elif kind == "random":
        a = rng.integers(0, hi, nelem)
    elif kind == "same":
        a = np.full(nelem, 123456789 % hi)
    elif kind == "rle":
        a = np.repeat(rng.integers(0, 255, max(1, nelem // 37) + 1), 37)[:nelem]
    elif kind == "smallrange":
        a = rng.integers(1000, 1032, nelem)
    else:
        raise ValueError(kind)
    if bpp in (1, 2, 4, 8):
        return a.astype(f"<u{bpp}").tobytes()
    return b"".join(int(v).to_bytes(16, "little")[:bpp] for v in a)
