"""4-stream byte delta filter — SPEC.md §2.2 (delta.cpp:30-71, 230+).

The 4-way stream split exists so the inverse (a byte prefix-sum) can run as 4
independent scans; on device delta_inv is a mod-256 cumulative sum which XLA
implements as a log-depth parallel scan.
"""

import numpy as np


def _split(n):
    if n <= 2048:
        return None
    return n // 4


def delta_np(src: np.ndarray) -> np.ndarray:
    n = len(src)
    if n == 0:
        return src.copy()
    s = src.astype(np.int32)
    out = np.empty(n, dtype=np.int32)
    q = _split(n)
    if q is None:
        out[0] = s[0]
        out[1:] = s[1:] - s[:-1]
    else:
        for k in range(4):
            st = k * q
            out[st] = s[st]
            out[st + 1 : st + q] = s[st + 1 : st + q] - s[st : st + q - 1]
        for j in range(4 * q, n):
            out[j] = s[j] - s[j - 1]
    return (out & 255).astype(np.uint8)


def delta_inv_np(src: np.ndarray) -> np.ndarray:
    n = len(src)
    if n == 0:
        return src.copy()
    s = src.astype(np.int64)
    out = np.empty(n, dtype=np.int64)
    q = _split(n)
    if q is None:
        out[:] = np.cumsum(s)
    else:
        for k in range(4):
            st = k * q
            out[st : st + q] = np.cumsum(s[st : st + q])
        prev = out[4 * q - 1] if n > 4 * q else 0
        for j in range(4 * q, n):
            prev = prev + s[j]
            out[j] = prev
    return (out & 255).astype(np.uint8)


def delta_jax(src):
    """jnp version (static shape)."""
    import jax.numpy as jnp

    n = src.shape[0]
    s = src.astype(jnp.int32)
    if n <= 2048:
        prev = jnp.concatenate([jnp.zeros(1, jnp.int32), s[:-1]])
        return ((s - prev) & 255).astype(jnp.uint8)
    q = n // 4
    head = s[: 4 * q].reshape(4, q)
    hprev = jnp.concatenate([jnp.zeros((4, 1), jnp.int32), head[:, :-1]], axis=1)
    out_head = ((head - hprev) & 255).reshape(-1)
    if n % 4:
        tail = s[4 * q :]
        tprev = jnp.concatenate([s[4 * q - 1 : 4 * q], tail[:-1]])
        out_tail = (tail - tprev) & 255
        return jnp.concatenate([out_head, out_tail]).astype(jnp.uint8)
    return out_head.astype(jnp.uint8)


def delta_inv_jax(src):
    import jax.numpy as jnp

    n = src.shape[0]
    s = src.astype(jnp.int32)
    if n <= 2048:
        return (jnp.cumsum(s) & 255).astype(jnp.uint8)
    q = n // 4
    head = (jnp.cumsum(s[: 4 * q].reshape(4, q), axis=1) & 255)
    if n % 4:
        prev = head[3, -1]
        tail = (jnp.cumsum(s[4 * q :]) + prev) & 255
        return jnp.concatenate([head.reshape(-1), tail]).astype(jnp.uint8)
    return head.reshape(-1).astype(jnp.uint8)
