"""Backend-generic (numpy / jax.numpy) section emission for the block codec.

Given the analysis results, build fixed-shape padded section contents +
lengths; callers compute offsets by cumsum and scatter into the output
buffer. This two-pass size→offset→scatter structure is the vector
replacement for the reference's pointer-walking emitters
(encode16x16_generic, block_compress.h:739-806).
"""


def compact16(xp, rows, keep):
    """Front-pack kept values of (..., 16) rows preserving order.

    Sort-free formulation that works identically in numpy and jnp: target
    position of kept element c is its exclusive prefix count; scatter via
    one-hot matmul (16x16, cheap on any backend).
    """
    import numpy as _np

    if xp is _np:  # host fast path: stable argsort compaction
        order = _np.argsort(~keep.astype(bool), axis=-1, kind="stable")
        return _np.take_along_axis(rows, order, axis=-1)
    k = keep.astype(xp.int32)
    pos = xp.cumsum(k, axis=-1) - k  # target slot for kept elements
    # one-hot: out[..., j] = sum_c rows[..., c] * (keep[c] & pos[c]==j)
    j = xp.arange(16, dtype=xp.int32)
    onehot = (pos[..., None] == j) & keep[..., None].astype(bool)
    return xp.sum(rows[..., None] * onehot.astype(xp.int32), axis=-2)


def mask16(xp, eq):
    w = (1 << xp.arange(16, dtype=xp.int32))
    return xp.sum(eq.astype(xp.int32) * w, axis=-1)


def plane_sections(xp, x, info, codes, firsts):
    """Build per-plane sections. x: (..., bpp, 16, 16) int32.

    Returns dict:
      headA (..., bpp, 8), lenA — hdr8 / SAME byte / nothing (RAW)
      minsec (..., bpp, 18), lenB
      rows (..., bpp, 16, 18), lenR
    """
    from ..ops.bitpack import pack16_any

    i32 = xp.int32
    h = info["headers"]
    normal = (codes == 2) | (codes == 3)

    hdr8 = h[..., 0::2] | (h[..., 1::2] << 4)
    same = (codes == 0)[..., None]
    first_col = xp.concatenate(
        [firsts[..., None], xp.zeros(hdr8.shape[:-1] + (7,), dtype=i32)],
        axis=-1,
    )
    headA = xp.where(same, first_col, hdr8)
    lenA = xp.where(codes == 0, 1, xp.where(normal, 8, 0))

    eligible = (h != 6) & (h != 7) & (h != 15)
    mins = info["minbytes"]
    plain16 = compact16(xp, mins, eligible)
    zeros2 = xp.zeros(mins.shape[:-1] + (2,), dtype=i32)
    plainB = xp.concatenate([plain16, zeros2], axis=-1)
    n_eligible = xp.sum(eligible.astype(i32), axis=-1)

    meq = info["meq"]
    mmask = mask16(xp, meq)
    rle_mins = compact16(xp, mins, ~meq)
    rleB = xp.concatenate(
        [(mmask & 255)[..., None], (mmask >> 8)[..., None], rle_mins], axis=-1
    )
    n_kept = xp.sum((~meq).astype(i32), axis=-1)

    is_rle = codes == 3
    minsec = xp.where(is_rle[..., None], rleB, plainB)
    lenB = xp.where(normal, xp.where(is_rle, 2 + n_kept, n_eligible), 0)

    d = info["deltas"]
    bitpack = ((h >= 1) & (h <= 5)) | ((h >= 9) & (h <= 14))
    b = xp.where(bitpack, h % 8, 0)
    sub = xp.where((h < 8)[..., None], x, d)
    v = (sub - mins[..., None]) & 255
    packed = pack16_any(xp, v, b)  # (..., 16, 12)
    rows = xp.concatenate(
        [packed, xp.zeros(h.shape + (6,), dtype=i32)], axis=-1
    )
    lenR = 2 * b

    raw = h == 15
    raw_rows = xp.concatenate(
        [x, xp.zeros(h.shape + (2,), dtype=i32)], axis=-1
    )
    rows = xp.where(raw[..., None], raw_rows, rows)
    lenR = xp.where(raw, 16, lenR)

    for hh, src, keepmask in ((7, x, info["eq"]), (6, d, info["deq"])):
        sel = h == hh
        m = mask16(xp, keepmask)
        body = compact16(xp, src, ~keepmask)
        cand = xp.concatenate(
            [(m & 255)[..., None], (m >> 8)[..., None], body], axis=-1
        )
        rows = xp.where(sel[..., None], cand, rows)
        lenR = xp.where(sel, 2 + xp.sum((~keepmask).astype(i32), axis=-1), lenR)

    lenR = xp.where(normal[..., None], lenR, 0)
    return {
        "headA": headA,
        "lenA": lenA,
        "minsec": minsec,
        "lenB": lenB,
        "rows": rows,
        "lenR": lenR,
    }


def block_header_bytes(xp, codes, bpp):
    """Nibble-pack per-plane codes -> (..., ceil(bpp/2)) bytes."""
    if bpp % 2:
        pad = xp.zeros(codes.shape[:-1] + (1,), dtype=xp.int32)
        codes = xp.concatenate([codes.astype(xp.int32), pad], axis=-1)
    else:
        codes = codes.astype(xp.int32)
    return codes[..., 0::2] | (codes[..., 1::2] << 4)
