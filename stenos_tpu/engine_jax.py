"""Device engine: the block codec as XLA programs.

One device pipeline runs on whatever backend JAX has (the GPU in
production, the CPU in tests):
  - encode: encode_superblocks_body analyses and emits every full block of
    a batch of superblocks, then one order-preserving compaction per
    superblock (ops/compact.py) produces the byte-exact stream;
    encode_records_body adds the 4-byte record header and, on request, the
    decode index (plane offsets with the 2-bit plane code in bits 24-25);
  - decode: decode_slabs_jit takes the host parser's row records (explicit
    index), decode_slabs_derive_jit derives them from the stream's own
    header bytes (derive index: plane offsets and codes only).
Sequential/host-only pieces (intra-block LZ attempts, libzstd entropy
stage, lz4-dry estimates) stay on the host runtime, operating on device
results.

Reference parity: byte-identical output to codec/encode_np.py (itself
bit-exact vs the C++ library) — enforced by tests/test_engine_jax.py and
tests/test_encode_pallas.py, and on the GPU by chip_smoke.py.
"""

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from .codec.analyze import analyze_planes, plane_kinds
from .codec.emit import block_header_bytes, plane_sections
from .constants import BLOCK_LZ, BLOCK_PARTIAL, ERROR_DST_OVERFLOW
from .codec.lz_np import lz_compress_block
from .codec.encode_np import encode_partial

# Bytes of input per device dispatch. Bounds device memory (the encode
# pipeline peaks near 50x its input) and the set of compiled shapes: a
# batch is cut into equal rounds plus one remainder.
ROUND_BYTES = 64 << 20


def rounds(n: int, item_bytes: int):
    """(first, count) of each dispatch round over n items of item_bytes."""
    per = max(1, ROUND_BYTES // item_bytes)
    return [(i, min(per, n - i)) for i in range(0, n, per)]


def _encode_core(data, bpp: int, block_level: int):
    """Shared encode body -> (out, total, block_sizes, full_sizes,
    plane_sizes (n_sb, nb, bpp), codes (n_sb, nb, bpp))."""
    from .ops.compact import compact

    n_sb, sbytes = data.shape
    block_size = 256 * bpp
    nb = sbytes // block_size
    hdr_w = (bpp + 1) // 2
    hdr_pad = 8 if hdr_w <= 8 else ((hdr_w + 7) // 8) * 8

    el = data.reshape(n_sb, nb, 256, bpp).astype(jnp.int32)
    x = el.transpose(0, 1, 3, 2).reshape(n_sb, nb, bpp, 16, 16)
    firsts = el[:, :, 0, :]

    info = analyze_planes(jnp, x, firsts, block_level >= 1)
    codes, psizes = plane_kinds(jnp, info, block_level)
    full_sizes = psizes.sum(axis=-1)

    sec = plane_sections(jnp, x, info, codes, firsts)
    bhdr = block_header_bytes(jnp, codes, bpp)

    # RAW planes re-use the 16 row slots as 16 raw 16-byte chunks
    is_raw = (codes == 1)[..., None]
    rows = jnp.where(
        is_raw[..., None],
        jnp.concatenate([x, jnp.zeros(x.shape[:-1] + (2,), jnp.int32)], -1),
        sec["rows"],
    )
    lenR = jnp.where(is_raw, 16, sec["lenR"])
    lenA = jnp.where(is_raw[..., 0], 0, sec["lenA"])
    lenB = jnp.where(is_raw[..., 0], 0, sec["lenB"])

    # Padded per-block layout: [bhdr(hdr_pad) | per plane: A(8) B(18) 16x18]
    plane_w = 8 + 18 + 16 * 18  # 314
    bhdr_pad = jnp.concatenate(
        [bhdr, jnp.zeros((n_sb, nb, hdr_pad - hdr_w), jnp.int32)], axis=-1
    )
    planes_flat = jnp.concatenate(
        [sec["headA"], sec["minsec"], rows.reshape(*rows.shape[:-2], 288)],
        axis=-1,
    )  # (n_sb, nb, bpp, 314)
    layout = jnp.concatenate(
        [bhdr_pad, planes_flat.reshape(n_sb, nb, bpp * plane_w)], axis=-1
    ).reshape(n_sb, nb * (hdr_pad + bpp * plane_w))

    # validity masks per lane
    def sec_mask(width, lens):
        return jnp.arange(width, dtype=jnp.int32) < lens[..., None]

    m_bhdr = sec_mask(hdr_pad, jnp.full((n_sb, nb), hdr_w, jnp.int32))
    m_planes = jnp.concatenate(
        [
            sec_mask(8, lenA),
            sec_mask(18, lenB),
            sec_mask(18, lenR).reshape(*lenR.shape[:-1], 288),
        ],
        axis=-1,
    )
    valid = jnp.concatenate(
        [m_bhdr, m_planes.reshape(n_sb, nb, bpp * plane_w)], axis=-1
    ).reshape(layout.shape)

    out, total = compact(jnp, layout, valid)
    out = out.astype(jnp.uint8)

    plane_sizes = lenA + lenB + lenR.sum(axis=-1)
    block_sizes = hdr_w + plane_sizes.sum(axis=-1)
    return out, total, block_sizes, full_sizes, plane_sizes, codes


def encode_superblocks_body(data, bpp: int, block_level: int):
    """Encode the full blocks of a batch of superblocks on device.

    data: (n_sb, sbytes) uint8 with sbytes % (256*bpp) == 0.
    Returns (out, total, block_sizes, full_sizes):
      out         (n_sb, max_out) uint8 padded block streams
      total       (n_sb,) stream length
      block_sizes (n_sb, nb) compressed size per block (for abort checks)
      full_sizes  (n_sb, nb) sum of plane sizes (for LZ candidacy)

    Emission strategy: lay every section out at its padded slot with a valid
    mask, then ONE order-preserving log-shift compaction per superblock
    (ops/compact.py) produces the byte-exact stream.
    """
    return _encode_core(data, bpp, block_level)[:4]


encode_superblocks_jit = partial(
    jax.jit, static_argnames=("bpp", "block_level")
)(encode_superblocks_body)


def encode_records_body(data, bpp: int, block_level: int,
                        with_index: bool = False):
    """Superblock records [method=1 | csize u24 | block stream].

    Returns (rows (n_sb, 4+max_out) uint8, totals (n_sb,) record lengths
    incl. the 4 header bytes, block_sizes, full_sizes) and, with_index,
    plane_off (n_sb, nb*bpp) int32 in stream order (p = block*bpp + plane):
    each plane's record-relative offset | plane code << 24. The index is
    all decode_slabs_derive_jit needs besides the rows, so a device round
    trip parses nothing on the host (4 B per 256-byte plane, 1.6%)."""
    out, total, bsizes, fsizes, psizes, codes = _encode_core(
        data, bpp, block_level)
    n_sb = out.shape[0]
    hdr4 = jnp.stack(
        [jnp.full(n_sb, 1, jnp.int32), total & 255, (total >> 8) & 255,
         (total >> 16) & 255], axis=-1).astype(jnp.uint8)
    rows = jnp.concatenate([hdr4, out], axis=-1)
    res = (rows, total + 4, bsizes, fsizes)
    if not with_index:
        return res
    hdr_w = (bpp + 1) // 2
    b_excl = jnp.cumsum(bsizes, axis=-1) - bsizes
    p_excl = jnp.cumsum(psizes, axis=-1) - psizes
    off = 4 + b_excl[..., None] + hdr_w + p_excl
    plane_off = (off | (codes << 24)).reshape(n_sb, -1).astype(jnp.int32)
    return res + (plane_off,)


encode_records_jit = partial(
    jax.jit, static_argnames=("bpp", "block_level", "with_index")
)(encode_records_body)


@partial(jax.jit, static_argnames=("bpp", "block_level"))
def roundtrip_device(batch, bpp: int, block_level: int = 2):
    """Device-resident compress -> decompress of (n_sb, sb) data in one
    dispatch with no host byte traffic: the encode emits the decode index
    beside the records, and the derive-index decoder reconstructs the row
    records from the stream's own header bytes.

    Returns (decoded (n_sb, sb) uint8 == batch, rows, totals) —
    rows[i, :totals[i]] are standard frame records."""
    nb = batch.shape[1] // (256 * bpp)
    rows, totals, _, _, plane_off = encode_records_body(
        batch, bpp, block_level, with_index=True)
    out = _decode_slabs_derive_body(rows, plane_off, bpp, nb)
    return out, rows, totals


class JaxEngine:
    """Engine adapter for frame.py: device compute + host patch-up."""

    def __init__(self, device=None):
        self.device = device

    def _encode_rounds(self, batch: np.ndarray, bpp: int, block_level: int):
        """One jit call over a (r, sb) batch -> list of per-superblock
        precomputed tuples."""
        out, total, bsizes, fsizes = encode_superblocks_jit(
            batch, bpp, block_level)
        out = np.asarray(out)
        total = np.asarray(total)
        bsizes = np.asarray(bsizes)
        fsizes = np.asarray(fsizes)
        return [(out[i], int(total[i]), bsizes[i], fsizes[i])
                for i in range(batch.shape[0])]

    def encode_batch(self, data: np.ndarray, bpp: int, sb: int,
                     block_level: int = 2):
        """Device encode of all full superblocks, in rounds of at most
        ROUND_BYTES; returns per-superblock precomputed results for
        finish_block_stream (None entries take the per-chunk path)."""
        nbytes = len(data)
        n_sb = -(-nbytes // sb)
        n_full = nbytes // sb
        block_size = 256 * bpp
        if n_full == 0 or sb % block_size:
            return [None] * n_sb
        pre = []
        for i, r in rounds(n_full, sb):
            sub = np.asarray(data[i * sb : (i + r) * sb]).reshape(r, sb)
            pre += self._encode_rounds(sub, bpp, block_level)
        pre += [None] * (n_sb - n_full)
        return pre

    def finish_block_stream(self, pre, chunk, bpp, budget, target_ratio,
                            block_level: int = 2, lz_table=None):
        """Host patch-up (LZ splice, abort/budget checks) of a precomputed
        device-encoded full superblock."""
        if pre is None:
            return self.encode_block_stream(chunk, bpp, budget, target_ratio,
                                            block_level, lz_table=lz_table)
        stream, total, bsizes, fsizes = pre
        nbytes = len(chunk)
        block_size = 256 * bpp
        nb = nbytes // block_size
        body = self._patch_lz(stream[:total], chunk, bpp, nb, bsizes, fsizes,
                              block_level, lz_table=lz_table)
        if target_ratio is not None:
            ends = np.cumsum(self._sizes_after_lz)
            cp = (nbytes // 16 + block_size - 1) // block_size - 1
            cp = max(cp, 0)
            if cp < nb and ((cp + 1) * block_size) / ends[cp] < target_ratio:
                return ERROR_DST_OVERFLOW
        if len(body) + 16 > budget or len(body) > budget:
            return ERROR_DST_OVERFLOW
        return body

    def encode_block_stream(self, chunk: np.ndarray, bpp: int, budget: int,
                            target_ratio=None, block_level: int = 2,
                            lz_table=None):
        nbytes = len(chunk)
        if nbytes == 0:
            return b""
        block_size = 256 * bpp
        nb = nbytes // block_size
        body = b""
        if nb:
            full = np.asarray(chunk[: nb * block_size]).reshape(1, -1)
            out, total, bsizes, fsizes = encode_superblocks_jit(
                full, bpp, block_level)
            out = np.asarray(out[0])
            total = int(total[0])
            bsizes = np.asarray(bsizes[0])
            fsizes = np.asarray(fsizes[0])
            body = self._patch_lz(
                out[:total], chunk, bpp, nb, bsizes, fsizes, block_level,
                lz_table=lz_table
            )
            if target_ratio is not None:
                # abort check (block_compress.h:1267-1274) on the (possibly
                # LZ-patched) sizes
                ends = np.cumsum(self._sizes_after_lz)
                cp = None
                for i in range(nb):
                    if (i + 1) * block_size >= nbytes // 16:
                        cp = i
                        break
                if cp is not None:
                    if ((cp + 1) * block_size) / ends[cp] < target_ratio:
                        return ERROR_DST_OVERFLOW
            if len(body) + 16 > budget:
                return ERROR_DST_OVERFLOW

        rem = nbytes - nb * block_size
        if rem:
            tail = encode_partial(np.asarray(chunk[nb * block_size:]), bpp)
            if len(body) + 1 + len(tail) + 8 > budget:
                return ERROR_DST_OVERFLOW
            body = body + bytes([BLOCK_PARTIAL]) + tail
        if len(body) > budget:
            return ERROR_DST_OVERFLOW
        return body

    def _patch_lz(self, stream, chunk, bpp, nb, bsizes, fsizes, block_level,
                  lz_table=None):
        """Host-side intra-block LZ attempts + splice (rare path)."""
        self._sizes_after_lz = bsizes.copy()
        if not (block_level == 2 and bpp % 4 == 0):
            return bytes(stream)
        block_size = 256 * bpp
        cand = np.nonzero(fsizes * 3 > block_size)[0]
        if not len(cand):
            return bytes(stream)
        budget = len(chunk)
        starts = np.zeros(nb + 1, dtype=np.int64)
        np.cumsum(bsizes, out=starts[1:])
        pieces = []
        pos = 0
        shrink = 0
        chunk = np.asarray(chunk)
        # the hash table persists across this superblock's LZ attempts
        # (the reference's per-iteration stack slot, block_compress.h:1211);
        # at level 1 the caller passes a FRAME-scoped table instead
        if lz_table is None:
            from .codec.lz_np import fresh_table

            lz_table = fresh_table()
        for i in cand:
            p = starts[i] - shrink
            if budget > p + fsizes[i] + bpp * 8 + 2:
                payload = lz_compress_block(
                    chunk[i * block_size : (i + 1) * block_size], bpp,
                    int(fsizes[i]), lz_table)
                if payload is not None:
                    pieces.append(bytes(stream[pos : starts[i]]))
                    pieces.append(bytes([BLOCK_LZ]))
                    pieces.append(payload)
                    pos = starts[i + 1]
                    shrink += bsizes[i] - (1 + len(payload))
                    self._sizes_after_lz[i] = 1 + len(payload)
        pieces.append(bytes(stream[pos:]))
        return b"".join(pieces)

    def decode_block_stream(self, payload, bpp, nbytes):
        """Decode via host row-parse + device decode of the full blocks."""
        from .codec.decode_np import block_codec_decode
        from .native import lib as native

        payload = bytes(memoryview(np.asarray(payload)))
        block_size = 256 * bpp
        nb = 1 if nbytes == block_size else nbytes // block_size
        if nb == 0:
            return block_codec_decode(payload, bpp, nbytes)
        parsed = native.parse_rows(payload, bpp, nbytes)
        if isinstance(parsed, int):
            return parsed
        vbuf, plane_off, row_rel, row_hdr, row_min, tail, _ = parsed
        # pad to a bucket so jit shapes are reused across superblocks
        bucket = _bucket(len(vbuf))
        vbuf = np.pad(vbuf, (0, bucket - len(vbuf)))
        Pn = nb * bpp
        planes = decode_rows_jit(vbuf, plane_off, row_rel, row_hdr, row_min,
                                 Pn)
        out = np.asarray(planes).reshape(nb, bpp, 256).transpose(0, 2, 1)
        out = out.reshape(nb * block_size)
        if len(tail):
            out = np.concatenate([out, tail])
        return out[:nbytes]


def block_records(frame: bytes, pos: int, n_sb: int):
    """(payload offsets, csizes) of n_sb consecutive method-BLOCK records
    starting at pos, or None when any record has another method."""
    offs, csizes = [], []
    for _ in range(n_sb):
        if pos + 4 > len(frame) or frame[pos] != 1:
            return None
        csize = int.from_bytes(frame[pos + 1 : pos + 4], "little")
        offs.append(pos + 4)
        csizes.append(csize)
        pos += 4 + csize
    return offs, csizes


def decode_tail_record(frame: bytes, pos: int, bpp: int, nbytes: int,
                       engine=None):
    """Decode the short final superblock record at pos (nbytes of
    output) through the frame layer's per-record ladder."""
    from .constants import ERROR_SRC_OVERFLOW
    from .frame import StenosError, decompress_superblock

    if pos + 4 > len(frame):
        raise StenosError(ERROR_SRC_OVERFLOW)
    csize = int.from_bytes(frame[pos + 1 : pos + 4], "little")
    payload = np.frombuffer(frame[pos + 4 : pos + 4 + csize], np.uint8)
    r = decompress_superblock(frame[pos], payload, bpp, nbytes, engine)
    return np.asarray(r, np.uint8).reshape(-1)


def decompress_frame_batched(frame: bytes, bpp: int, engine=None):
    """Decode a frame whose full superblocks are all method BLOCK (the
    level-1/2 typed-array fast path): the batched C++ parser builds the row
    records and decode_slabs_jit decodes them, one dispatch per ROUND_BYTES
    of output; each round's decode is in flight while the host parses the
    next. A short final superblock takes the per-record ladder.

    Returns a numpy array, or None when the frame does not have that shape
    (the caller then decodes record by record)."""
    from .constants import ERROR_INVALID_INPUT
    from .frame import StenosError, get_info
    from .native import lib as native

    frame = bytes(frame)
    dsize_total, sb, pos = get_info(frame, bpp)
    block_size = 256 * bpp
    n_sb = dsize_total // sb
    if n_sb == 0 or sb % block_size:
        return None
    nb = sb // block_size
    recs = block_records(frame, pos, n_sb)
    if recs is None:
        return None
    offs, csizes = recs
    row_bytes = _bucket125(max(csizes) + 512)
    pending = []
    for c0, count in rounds(n_sb, sb):
        c1 = c0 + count
        r = native.parse_rows_batch(frame, bpp, sb, offs[c0:c1],
                                    csizes[c0:c1], row_bytes)
        if isinstance(r, int):
            raise StenosError(ERROR_INVALID_INPUT)
        vbufs, plane_off, rowtab, _ = r
        pending.append(decode_slabs_jit(vbufs, plane_off, rowtab, bpp, nb))
    out = [np.asarray(o).reshape(-1) for o in pending]
    if dsize_total > n_sb * sb:
        out.append(decode_tail_record(frame, offs[-1] + csizes[-1], bpp,
                                      dsize_total - n_sb * sb, engine))
    return np.concatenate(out)


@partial(jax.jit, static_argnames=("cap",), donate_argnums=())
def _frame_assemble_jit(rows, offs, header, cap: int):
    n_sb, w = rows.shape
    frame = jnp.zeros(cap, jnp.uint8)
    frame = jax.lax.dynamic_update_slice(frame, header, (0,))

    def body(i, fr):
        # ordered overlapping copies build the ragged frame: later rows
        # overwrite earlier rows' padding (the parallel-memcpy round of
        # stenos.cpp:992-1004); XLA keeps the loop carry in place
        return jax.lax.dynamic_update_slice(
            fr, jax.lax.dynamic_index_in_dim(rows, i, keepdims=False),
            (offs[i],))

    return jax.lax.fori_loop(0, n_sb, body, frame)


def _frame_assemble(rows, offs, header, cap: int):
    """Ragged frame assembly in device memory. header: frame header bytes
    (8, or 12 for custom-blocksize frames); offs must already include the
    header length. A fori_loop of in-place dynamic_update_slice — one
    contiguous copy per superblock, the XLA spelling of the reference's
    parallel memcpy round."""
    cap = max(int(cap), header.shape[0])
    return _frame_assemble_jit(rows, offs, header, cap)


def frame_header_bytes(nbytes: int, sb: int, bpp: int, level: int):
    """Frame header for a device-assembled frame: the standard shift byte
    when sb matches the level's superblock size, else the custom-blocksize
    form (shift 255 + LE32 sb, stenos.cpp:868-874)."""
    from .frame import StenosError, _superblock_params

    try:
        std_sb, shift = _superblock_params(bpp, nbytes, level)
    except StenosError:
        std_sb, shift = -1, 0
    if sb == std_sb:
        hdr = bytes([shift]) + nbytes.to_bytes(7, "little")
    else:
        hdr = bytes([255]) + nbytes.to_bytes(7, "little") \
            + sb.to_bytes(4, "little")
    return np.frombuffer(hdr, np.uint8)


def compress_frame_device_jit(data, bpp: int, level: int):
    """Fully device-resident level-1 frame compression (method BLOCK).

    data: (n_sb, sb) uint8 (whole input, sb | len). Returns (frame, size):
    frame stays in device memory — the equivalent of the reference's
    RAM-to-RAM compress path (whose final serial memcpy pass,
    stenos.cpp:977-1004, becomes the ordered device assembly here).
    """
    n_sb, sb = data.shape
    nbytes = n_sb * sb
    rows, sizes, _, _ = encode_records_jit(data, bpp, 2)
    offs = 8 + jnp.cumsum(sizes) - sizes
    hdr = frame_header_bytes(nbytes, sb, bpp, level)
    base = len(hdr)
    cap = base + n_sb * rows.shape[1]
    frame = _frame_assemble(rows, offs + (base - 8), jnp.asarray(hdr), cap)
    frame_len = base + jnp.sum(sizes)
    return frame, frame_len


def _bucket(n: int) -> int:
    b = 4096
    while b < n:
        b *= 2
    return b


def _bucket125(n: int) -> int:
    """Geometric ~1.25x buckets rounded to 512: bounds both shape variety
    (compile cache) and H2D padding waste (<= 25%)."""
    b = 4096
    while b < n:
        b = -(-(b + b // 4) // 512) * 512
    return b


_ROW_SIZE_LUT = np.array(
    [0, 2, 4, 6, 8, 10, 0, 0, 0, 2, 4, 6, 8, 10, 12, 16], dtype=np.int32
)


def expand_rows(xp, win, rel, W: int = 18):
    """Within-window expansion: split (P, Lw) plane windows into (P, 16, W)
    row windows at in-window starts rel (P, 16) (monotone; consecutive rows
    contiguous so strides <= 18 — the expansion contract holds by format).

    Owner/segment-start are computed with dense comparisons (16-wide) rather
    than scatters."""
    Lw = win.shape[-1]
    i32 = xp.int32
    j = xp.arange(Lw, dtype=i32)
    started = rel[:, None, :] <= j[None, :, None]  # (P, Lw, 16)
    owner = xp.sum(started.astype(i32), axis=-1) - 1
    start_of = xp.max(
        xp.where(started, rel[:, None, :], -1), axis=-1
    )
    inwin = j[None, :] - start_of
    dest_ok = (owner >= 0) & (inwin < W)
    target = Lw + owner * 18 + inwin
    shift = xp.where(dest_ok, target - j[None, :], 0)
    v = win.astype(i32) & 255
    w = xp.where(dest_ok, v | (shift << 8) | (1 << 30), 0)
    from .ops.compact import shift_right_packed

    out_w = Lw + 16 * W
    pad = xp.zeros(win.shape[:-1] + (out_w - Lw,), i32)
    w = xp.concatenate([w, pad], axis=-1)
    w = shift_right_packed(xp, w, out_w)
    out = (w & 255)[..., Lw:]
    return out.reshape(out.shape[:-1] + (16, W))


def _plane_windows(vbuf, plane_off):
    """(L,) stream -> (P, 320) windows, one per plane starting at its
    offset (plane strides <= 320 by format)."""
    from .ops.compact import expand

    return expand(jnp, vbuf, plane_off.astype(jnp.int32), 320)


def _derive_rows(Wp, code):
    """Row records (rel, hdr, min), each (P, 16), from the plane windows
    Wp (P, 320) and plane codes (P,) 0..3 (parse_plane_rows_packed
    semantics, stenos_native.cpp): header nibbles from window bytes 0..7
    (NORMAL planes), mins from the plain or RLE-coded mins section, row
    offsets from the per-header row sizes, where RLE rows (headers 6/7)
    read their own 16-bit mask."""
    from .ops.compact import fill_left

    i32 = jnp.int32
    P = Wp.shape[0]
    c = code[:, None]
    hb = Wp[:, 0:8]
    h_nib = jnp.stack([hb & 15, hb >> 4], axis=-1).reshape(P, 16)
    hdr = jnp.where(c == 0, 0, jnp.where(c == 1, 15, h_nib))

    def take(idx):
        return jnp.take_along_axis(Wp, jnp.clip(idx, 0, Wp.shape[1] - 1),
                                   axis=1)

    # plain mins: one byte per eligible row, consecutive from byte 8
    el = (h_nib != 6) & (h_nib != 7) & (h_nib != 15)
    eli = el.astype(i32)
    el_excl = jnp.cumsum(eli, axis=1) - eli
    mins_plain = jnp.where(el, take(8 + el_excl), 0)
    # RLE-coded mins (code 3): 16-bit mask at 8, literals from 10; a set
    # bit repeats the previous row's min (seed 0)
    mmask = Wp[:, 8:9] | (Wp[:, 9:10] << 8)
    lit = ((mmask >> jnp.arange(16, dtype=i32)) & 1) == 0
    liti = lit.astype(i32)
    lit_excl = jnp.cumsum(liti, axis=1) - liti
    mins_rle, _ = fill_left(jnp, jnp.where(lit, take(10 + lit_excl), 0),
                            lit, 16)
    mins_n = jnp.where(c == 3, mins_rle, mins_plain)
    mn = jnp.where(c == 0, Wp[:, 0:1], jnp.where(c == 1, 0, mins_n))

    size = jnp.asarray(_ROW_SIZE_LUT)[h_nib]
    is_rle = (h_nib == 6) | (h_nib == 7)
    rel = jnp.where(code == 3, 10 + liti.sum(axis=1), 8 + eli.sum(axis=1))
    rels = []
    for r in range(16):
        rels.append(rel)
        m = take(rel[:, None])[:, 0] | (take(rel[:, None] + 1)[:, 0] << 8)
        rle_size = 18 - jax.lax.population_count(m)
        rel = rel + jnp.where(is_rle[:, r], rle_size, size[:, r])
    rows16 = jnp.arange(16, dtype=i32)
    rel = jnp.where(c == 0, 1,
                    jnp.where(c == 1, rows16 * 16, jnp.stack(rels, axis=1)))
    return rel, hdr, mn


def _decode_planes(Wp, row_rel, row_hdr, row_min):
    """Plane windows + row records -> (P*256,) plane-major bytes.

    Sequential structure is gone by construction: the row expansion places
    each row's payload in an 18-byte window (row strides <= 18); within-row
    RLE becomes placement (log-shift) + fill-left; the cross-row carry is
    the affine recurrence out = a + b*prev_last (mod 256).
    """
    from .ops.compact import fill_left

    i32 = jnp.int32
    P = Wp.shape[0]
    h = row_hdr.astype(i32).reshape(P * 16)
    mins = row_min.astype(i32).reshape(P * 16)
    R = P * 16

    W = expand_rows(jnp, Wp, row_rel.astype(i32)).astype(i32)
    W = W.reshape(R, 18)

    # --- RLE reconstruction (h 6/7): mask -> placement + fill-left
    rmask = W[:, 0] | (W[:, 1] << 8)
    rbit = (rmask[:, None] >> jnp.arange(16)) & 1  # 1 = repeat
    lit = rbit == 0
    # kept bytes W[2:18] are consecutive; spread them to literal positions
    litc = jnp.cumsum(lit.astype(i32), axis=-1)
    placed = expand_literals(W[:, 2:18], lit, litc)
    rle_vals, have = fill_left(jnp, placed, lit, 16)
    rle_bflag = (~have).astype(i32)  # leading repeats take prev_last

    # --- bit-packed values
    from .ops.bitpack import unpack16

    bitpack_row = ((h >= 1) & (h <= 5)) | ((h >= 9) & (h <= 14))
    bwidth = jnp.where(bitpack_row, h % 8, 0)
    vals = jnp.zeros((R, 16), i32)
    for b in range(1, 7):
        vals = jnp.where(
            (bwidth == b)[:, None], unpack16(jnp, W[:, :12], b), vals
        )

    h2 = h[:, None]
    direct_a = (vals + mins[:, None]) & 255
    delta_a = jnp.cumsum(vals + mins[:, None], axis=-1) & 255
    drle_a = jnp.cumsum(rle_vals, axis=-1) & 255
    a = jnp.where(h2 == 15, W[:, :16], direct_a)
    a = jnp.where((h2 >= 8) & (h2 <= 14), delta_a, a)
    a = jnp.where(h2 == 6, drle_a, a)
    a = jnp.where(h2 == 7, rle_vals, a)
    bflag = jnp.zeros((R, 16), i32)
    bflag = jnp.where((h2 >= 8) & (h2 <= 14), 1, bflag)
    bflag = jnp.where(h2 == 6, 1, bflag)
    bflag = jnp.where(h2 == 7, rle_bflag, bflag)

    # --- affine chain over the 16 rows of each plane
    a = a.reshape(P, 16, 16)
    bflag = bflag.reshape(P, 16, 16)

    def chain_step(pl_, r):
        nxt = (a[:, r, 15] + bflag[:, r, 15] * pl_) & 255
        return nxt, pl_

    _, pls = jax.lax.scan(chain_step, jnp.zeros(P, i32), jnp.arange(16))
    pls = pls.T
    planes = (a + bflag * pls[:, :, None]) & 255
    return planes.reshape(R * 16).astype(jnp.uint8)


def _decode_rows_body(vbuf, plane_off, row_rel, row_hdr, row_min, P: int):
    """vbuf: (L,) uint8 virtual stream (LZ/COPY pre-spliced by the parser);
    plane_off (P,), row_rel/hdr/min (P, 16). Returns (P*256,) plane-major
    bytes (caller reshapes (nb, bpp, 256) and unshuffles)."""
    return _decode_planes(_plane_windows(vbuf, plane_off), row_rel,
                          row_hdr, row_min)


decode_rows_jit = partial(jax.jit, static_argnames=("P",))(_decode_rows_body)


def _planes_to_bytes(planes, nb: int, bpp: int):
    """(n, nb*bpp*256) plane-major bytes -> (n, nb*256*bpp) natural order."""
    n = planes.shape[0]
    return planes.reshape(n, nb, bpp, 256).transpose(0, 1, 3, 2).reshape(
        n, nb * 256 * bpp)


@partial(jax.jit, static_argnames=("bpp", "nb"))
def decode_slabs_jit(vbufs, plane_off, rowtab, bpp: int, nb: int):
    """Explicit-index decode of n slabs of nb blocks each.

    vbufs (n, L) uint8 virtual payloads; plane_off (n, P) int32 (low 24
    bits; the batched parser puts the plane code in bits 24-25); rowtab
    (n, 16, P) int32 packed rel | hdr << 10 | min << 14 — the output of
    native.parse_rows_batch. Returns (n, nb*256*bpp) uint8."""
    rt = rowtab.transpose(0, 2, 1)
    planes = jax.vmap(
        lambda v, o, r: _decode_rows_body(
            v, o & 0xFFFFFF, r & 1023, (r >> 10) & 15, (r >> 14) & 255,
            nb * bpp))(vbufs, plane_off, rt)
    return _planes_to_bytes(planes, nb, bpp)


def _decode_slabs_derive_body(vbufs, plane_off, bpp: int, nb: int):
    def one(vbuf, po):
        Wp = _plane_windows(vbuf, po & 0xFFFFFF)
        rel, hdr, mn = _derive_rows(Wp, (po >> 24) & 3)
        return _decode_planes(Wp, rel, hdr, mn)

    return _planes_to_bytes(jax.vmap(one)(vbufs, plane_off), nb, bpp)


@partial(jax.jit, static_argnames=("bpp", "nb"))
def decode_slabs_derive_jit(vbufs, plane_off, bpp: int, nb: int):
    """Derive-index decode of n slabs.

    vbufs (n, L) uint8; plane_off (n, P) int32 packed offset | code << 24
    in stream order (what encode_records_body emits with_index). Row
    records are derived from the stream's own header bytes, so no row
    table is stored. Returns (n, nb*256*bpp) uint8."""
    return _decode_slabs_derive_body(vbufs, plane_off, bpp, nb)


def expand_literals(kept, lit, litc):
    """Place consecutive kept bytes at literal positions (tiny log-shift
    right over 16 lanes): kept (R,16) in order; literal position i receives
    kept[litc[i]-1]."""
    i32 = jnp.int32
    # the destination of kept byte j is the position of the j-th literal:
    # compact the per-literal shifts to the source side, then move right
    pos = jnp.arange(16, dtype=i32)
    shift = jnp.where(lit, pos - (litc - 1), 0)
    from .ops.compact import compact

    dshift, _ = compact(jnp, shift, lit, 16)  # shift for kept byte j
    wv = kept.astype(i32) & 255
    valid = jnp.arange(16) < jnp.sum(lit, axis=-1)[:, None]
    w = jnp.where(valid, wv | (dshift << 8) | (1 << 30), 0)
    for k in reversed(range(4)):
        bit = 1 << k
        moved = jnp.roll(w, bit, axis=-1)
        head = jnp.arange(16, dtype=i32) < bit
        moved = jnp.where(head, 0, moved)
        arrive = ((moved >> 8) & bit) != 0
        stay = (w != 0) & (((w >> 8) & bit) == 0)
        w = jnp.where(arrive, moved - (bit << 8), jnp.where(stay, w, 0))
    return w & 255
