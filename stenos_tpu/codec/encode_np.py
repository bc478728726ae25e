"""Host (numpy) encoder for the stenos block-codec stream (SPEC.md §3).

This is the vectorized reference implementation used for tests and as the CPU
fallback path; the device (jnp/Pallas) encoder in encode_jax.py shares the
same analysis code (codec/analyze.py) and emission layout.

Emission strategy (vector two-pass, also used on device): compute every
section's length, exclusive-cumsum into offsets, then scatter each
width-class of sections into the output buffer — no pointer walking.
"""

import numpy as np

from ..constants import (
    BLOCK_LZ,
    BLOCK_PARTIAL,
    ERROR_DST_OVERFLOW,
    RAW_DIFF,
)
from .analyze import analyze_planes, plane_kinds
from ..ops.bitpack import pack16_any
from .lz_np import lz_compress_block


from .emit import block_header_bytes, plane_sections


def assemble(sections_len, writes, total):
    """Scatter width-class section contents into one output byte buffer.

    sections_len: flat (S,) int lengths in stream order -> offsets by cumsum.
    writes: list of (section_index_array, content_2d, length_array) tuples.
    """
    offsets = np.zeros(len(sections_len) + 1, dtype=np.int64)
    np.cumsum(sections_len, out=offsets[1:])
    out = np.zeros(total, dtype=np.uint8)
    for idx, content, lens in writes:
        if content.size == 0:
            continue
        w = content.shape[-1]
        flat_c = content.reshape(-1, w)
        flat_l = lens.reshape(-1)
        offs = offsets[idx.reshape(-1)]
        cols = np.arange(w)
        mask = cols[None, :] < flat_l[:, None]
        dst_idx = offs[:, None] + cols[None, :]
        out[dst_idx[mask]] = flat_c.astype(np.uint8)[mask]
    return out, offsets


def encode_full_blocks(data: np.ndarray, bpp: int, block_level: int = 2,
                       lz_enabled: bool = True, lz_budget=None,
                       lz_table=None):
    """Encode all full 256-element blocks of a superblock.

    data: uint8 1D, length a multiple of 256*bpp (callers strip the tail).
    lz_budget: dst room for the LZ escape's precondition — the reference
    passes the SUPERBLOCK's total input size as dst_size
    (stenos.cpp:547, block_compress.h:1214), which exceeds len(data) when
    a partial tail exists; defaulting to len(data) suppressed LZ attempts
    on short superblocks (found by tools/fuzz_parity.py).
    Returns (payload_bytes, per_block_end_offsets) — offsets are cumulative
    compressed sizes after each block, used for the frame layer's
    target-ratio abort check (block_compress.h:1267-1274).
    """
    block_size = 256 * bpp
    nb = len(data) // block_size
    el = data.reshape(nb, 256, bpp)
    x = el.transpose(0, 2, 1).reshape(nb, bpp, 16, 16).astype(np.int32)
    firsts = el[:, 0, :].astype(np.int32)  # (nb, bpp)

    info = analyze_planes(np, x, firsts, block_level >= 1)
    codes, psizes = plane_kinds(np, info, block_level)
    full_size = psizes.sum(axis=1)  # (nb,)

    # Intra-block LZ attempts (block_compress.h:1209-1223). The dst-room
    # precondition uses the running output position with budget len(data);
    # with sizes known this is a cheap sequential pass.
    lz_payloads = {}
    hdr_w = (bpp + 1) // 2
    if lz_enabled and block_level == 2 and bpp % 4 == 0:
        cand = np.nonzero(full_size * 3 > block_size)[0]
        if len(cand):
            # Running positions assuming no LZ yet; LZ only shrinks blocks, and
            # the room check uses the position at that block's start.
            sizes_noLZ = hdr_w + full_size
            pos = np.zeros(nb, dtype=np.int64)
            np.cumsum(sizes_noLZ[:-1], out=pos[1:])
            budget = len(data) if lz_budget is None else lz_budget
            shrink = 0
            # the hash table persists across the superblock's LZ attempts
            # (the reference's per-iteration stack slot, block_compress.h:1211);
            # at level 1 the caller passes a FRAME-scoped table instead
            if lz_table is None:
                from .lz_np import fresh_table

                lz_table = fresh_table()
            for i in cand:
                p = pos[i] - shrink
                if budget > p + full_size[i] + bpp * 8 + 2:
                    payload = lz_compress_block(
                        data[i * block_size : (i + 1) * block_size], bpp,
                        int(full_size[i]), lz_table)
                    if payload is not None:
                        lz_payloads[int(i)] = payload
                        shrink += sizes_noLZ[i] - (1 + len(payload))

    # Section layout per block: [bhdr][lz][ (A B r0..r15) * bpp ]
    per_block = 2 + bpp * 18
    S = nb * per_block
    lens = np.zeros((nb, per_block), dtype=np.int64)

    # block header nibbles
    bhdr = np.ascontiguousarray(block_header_bytes(np, codes, bpp))
    lens[:, 0] = hdr_w

    sec = plane_sections(np, x, info, codes, firsts)
    planes_lens = np.concatenate(
        [
            sec["lenA"][..., None],
            sec["lenB"][..., None],
            sec["lenR"],
        ],
        axis=-1,
    )  # (nb, bpp, 18)
    lens[:, 2:] = planes_lens.reshape(nb, bpp * 18)

    # RAW planes are written as their own 256-byte sections: reuse slot A by
    # giving it the raw plane content? widths differ; instead use the row
    # slots trick: simplest is a dedicated write pass below with lenA slot
    # repurposed. We keep a separate raw write using slot A's offset.
    is_raw = codes == 1
    lens_A = np.where(is_raw, 256, sec["lenA"])
    lens[:, 2::18] = lens_A

    # LZ blocks: header shrinks to the marker byte, plane sections vanish.
    for i, payload in lz_payloads.items():
        lens[i, 0] = 1
        lens[i, 1] = len(payload)
        lens[i, 2:] = 0

    flat_lens = lens.reshape(-1)
    total = int(flat_lens.sum())

    sidx = np.arange(S).reshape(nb, per_block)
    is_lz = np.zeros(nb, dtype=bool)
    if lz_payloads:
        is_lz[sorted(lz_payloads)] = True
        bhdr[is_lz, 0] = BLOCK_LZ
    plane_sidx = sidx[:, 2:].reshape(nb, bpp, 18)
    plane_lens = lens[:, 2:].reshape(nb, bpp, 18)
    writes = [
        (sidx[:, 0], bhdr, lens[:, 0]),
        (plane_sidx[..., 0][~is_raw], sec["headA"][~is_raw],
         plane_lens[..., 0][~is_raw]),
        (plane_sidx[..., 1], sec["minsec"], plane_lens[..., 1]),
        (plane_sidx[..., 2:], sec["rows"], plane_lens[..., 2:]),
    ]
    if is_raw.any():
        raw_content = x.reshape(nb, bpp, 256)[is_raw]
        writes.append(
            (plane_sidx[..., 0][is_raw], raw_content,
             plane_lens[..., 0][is_raw])
        )

    out, offsets = assemble(flat_lens, writes, total)

    # splice LZ payload bytes
    for i, payload in lz_payloads.items():
        off = offsets[i * per_block + 1]
        out[off : off + len(payload)] = np.frombuffer(payload, dtype=np.uint8)

    block_ends = offsets[per_block::per_block].copy()
    return out, block_ends


def encode_partial(tail: np.ndarray, bpp: int):
    """Encode the final partial segment (SPEC.md §3.3) WITHOUT the 0xFE marker."""
    from ..ops.shuffle import shuffle_np

    rbytes = len(tail)
    block_size = 256 * bpp
    line_size = 16 * bpp
    lines = rbytes // line_size
    out = bytearray()

    if lines:
        buf = np.empty(block_size, dtype=np.uint8)
        buf[:rbytes] = tail
        buf[rbytes:] = tail[-1]
        planes = shuffle_np(buf, bpp).reshape(bpp, 16, 16).astype(np.int32)
        firsts = buf[:bpp].astype(np.int32)
        info = analyze_planes(np, planes[None], firsts[None], False)
        hdr_w = (bpp + 1) // 2

        # plane codes: only ALL_SAME / NORMAL
        codes = np.where(info["all_same"][0], 0, 2)
        nibbles = np.zeros(hdr_w * 2, dtype=np.int32)
        nibbles[:bpp] = codes
        out += bytes((nibbles[0::2] | (nibbles[1::2] << 4)).astype(np.uint8))

        h = info["headers"][0]
        mins = info["minbytes"][0]
        d = info["deltas"][0]
        for p in range(bpp):
            if codes[p] == 0:
                out.append(int(firsts[p]))
                continue
            hp = h[p]
            # headers for `lines` rows only, nibble packed (encode_lines)
            hl = hdrs = hp[:lines]
            nib = np.zeros(((lines + 1) // 2) * 2, dtype=np.int64)
            nib[:lines] = hdrs
            anchor = bytes((nib[0::2] | (nib[1::2] << 4)).astype(np.uint8))
            out += anchor
            for r in range(lines):
                if hdrs[r] not in (6, 7, 15):
                    out.append(int(mins[p, r]))
            for r in range(lines):
                out += _encode_row_np(
                    int(hp[r]), planes[p, r], d[p, r], int(mins[p, r])
                )
    rem = rbytes - lines * line_size
    if rem:
        out += tail[lines * line_size :].tobytes()
    return bytes(out)


def _encode_row_np(h, xrow, drow, minb):
    """Scalar row encoder used by the partial path (no RLE there, but keep
    the general form for reuse in tests)."""
    from ..ops.bitpack import pack16

    if h in (0, 8):
        return b""
    if h == 15:
        return bytes(xrow.astype(np.uint8))
    b = h % 8 if h < 8 else h - 8
    sub = xrow if h < 8 else drow
    v = (sub - minb) & 255
    return bytes(pack16(np, v.astype(np.int32), b).astype(np.uint8))


def block_codec_encode(data: np.ndarray, bpp: int, dst_budget: int,
                       block_level: int = 2, target_ratio=None,
                       lz_enabled=None, lz_table=None):
    """Full block_compress equivalent: full blocks + partial tail.

    Returns payload bytes, or ERROR_DST_OVERFLOW (int) on budget overrun or
    target-ratio abort.
    """
    nbytes = len(data)
    if nbytes == 0:
        return b""
    block_size = 256 * bpp
    nb = nbytes // block_size
    if lz_enabled is None:
        lz_enabled = block_level == 2

    parts = []
    body_len = 0
    if nb:
        body, block_ends = encode_full_blocks(
            data[: nb * block_size], bpp, block_level, lz_enabled,
            lz_budget=nbytes, lz_table=lz_table
        )
        # target-ratio abort (block_compress.h:1267-1274): checked after the
        # first block whose consumed input reaches bytes/16.
        if target_ratio is not None and nb > 0:
            checkpoint = None
            for i in range(nb):
                if (i + 1) * block_size >= nbytes // 16:
                    checkpoint = i
                    break
            if checkpoint is not None:
                ratio = ((checkpoint + 1) * block_size) / block_ends[checkpoint]
                if ratio < target_ratio:
                    return ERROR_DST_OVERFLOW
        parts.append(body)
        body_len = len(body)
        # dst budget checks (approximate the reference's incremental slack:
        # final size must fit; per-plane +16 slack on the last write)
        if body_len + 16 > dst_budget:
            return ERROR_DST_OVERFLOW

    rem = nbytes - nb * block_size
    if rem:
        tail = encode_partial(data[nb * block_size :], bpp)
        if body_len + 1 + len(tail) + 8 > dst_budget:
            return ERROR_DST_OVERFLOW
        parts.append(bytes([BLOCK_PARTIAL]))
        parts.append(tail)

    out = b"".join(bytes(memoryview(p)) for p in parts)
    if len(out) > dst_budget:
        return ERROR_DST_OVERFLOW
    return out
