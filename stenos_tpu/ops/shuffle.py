"""Byte shuffle (Blosc-style transpose) — SPEC.md §2.1.

On device this is a reshape+transpose that XLA lowers to an efficient layout
change; no hand-written kernel needed (the reference needs 1600 lines of
SSE2/AVX2 for the same op: shuffle-sse2.cpp, shuffle-avx2.cpp).
"""

import numpy as np


def shuffle_np(data: np.ndarray, bpp: int) -> np.ndarray:
    """dst[p*ne + e] = src[e*bpp + p]; trailing n % bpp bytes copied as-is."""
    n = data.shape[0]
    if bpp == 1:
        return data.copy()
    ne = n // bpp
    rem = n % bpp
    out = np.empty_like(data)
    out[: ne * bpp] = data[: ne * bpp].reshape(ne, bpp).T.reshape(-1)
    if rem:
        out[ne * bpp :] = data[ne * bpp :]
    return out


def unshuffle_np(data: np.ndarray, bpp: int) -> np.ndarray:
    n = data.shape[0]
    if bpp == 1:
        return data.copy()
    ne = n // bpp
    rem = n % bpp
    out = np.empty_like(data)
    out[: ne * bpp] = data[: ne * bpp].reshape(bpp, ne).T.reshape(-1)
    if rem:
        out[ne * bpp :] = data[ne * bpp :]
    return out


def shuffle_jax(data, bpp: int):
    """jnp version over a statically-shaped uint8 vector (len % bpp == 0)."""
    import jax.numpy as jnp

    if bpp == 1:
        return data
    ne = data.shape[0] // bpp
    return data.reshape(ne, bpp).T.reshape(-1)


def unshuffle_jax(data, bpp: int):
    import jax.numpy as jnp

    if bpp == 1:
        return data
    ne = data.shape[0] // bpp
    return data.reshape(bpp, ne).T.reshape(-1)
