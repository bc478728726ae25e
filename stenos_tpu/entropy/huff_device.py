"""Device Huffman literal coding for the zstd entropy stage (plain jnp).

Encode (HUF_compress4X's bulk work) per 32 KiB stream: huff0 emits the
symbols back to front, so the stream is reversed; codes come by table
lookup; each code's bit offset is an exclusive prefix sum of the code
lengths; and each code lands in at most two 32-bit words. Codes never
share a bit, so the per-word OR is a scatter-add. The prefix sums also
give the decode anchors for free: the bit read position of every
K = 128th original symbol.

Decode: the bitstream is a backward-read prefix code, inherently
sequential within a stream. The anchors cut every stream into 256
segments of K symbols that decode independently, so one lax.scan over
the K symbols of a segment runs all segments of all streams at once.

Canonical convention matches huffman.build_ctable: codes dealt from 0
upward starting at the LONGEST length; for length l the codes occupy
[base_l, base_l + n_l) and left-aligned 11-bit windows tile [0, 2^11).
Streams are bit-identical to the host encoder (huf_encode_stream) —
tests/test_entropy_pallas.py.
"""

import numpy as np

import jax
import jax.numpy as jnp

from .huffman import MAX_BITS

K = 128            # symbols per segment (anchor spacing)
SEGS = 256         # segments per 32 KiB stream
STREAM = K * SEGS  # 32768 symbols per stream (a 128 KiB block / 4)
BLOCK = 4 * STREAM
WORDS = 12288      # output words per stream: >= (11*STREAM + 1) / 32


def anchors_host(data: np.ndarray, lens_lut: np.ndarray) -> np.ndarray:
    """Host reference for the encoder's anchors: data (32768,) symbols,
    lens_lut (256,) code lengths -> (256,) int32 bit read positions
    (anchors[g] = position of symbol g*K, counting from the stream bottom;
    anchors[0] = total bits)."""
    lens_em = lens_lut[np.asarray(data)[::-1]].astype(np.int64)
    incl = np.cumsum(lens_em)
    return incl[127::128][::-1].astype(np.int32)


@jax.jit
def histogram_device(blocks):
    """blocks (nblk, 131072) uint8 -> (nblk, 256) int32 symbol counts."""
    return jax.vmap(lambda b: jnp.bincount(b, length=256))(
        blocks.astype(jnp.int32)).astype(jnp.int32)


@jax.jit
def encode_streams_device(streams, luts):
    """streams (ns, 32768) uint8; luts (ns, 256) int32 (code | len << 11).
    -> (words (ns, WORDS) uint32 LE bitstreams, sizes (ns,) bytes,
    anchors (ns, 256) int32 decode read positions in segment order)."""
    ns = streams.shape[0]
    xe = streams[:, ::-1].astype(jnp.int32)           # emission order
    acc = jnp.take_along_axis(luts, xe, axis=1)
    lens = acc >> 11
    code = (acc & 2047).astype(jnp.uint32)
    incl = jnp.cumsum(lens, axis=1)
    total = incl[:, -1]
    off = incl - lens
    w0 = off >> 5
    sh = (off & 31).astype(jnp.uint32)
    lo = code << sh
    # the part of the code above bit 31 of word w0 (0 when it fits)
    hi = (code >> 1) >> (31 - sh)
    rows = jnp.arange(ns)[:, None]
    words = jnp.zeros((ns, WORDS + 1), jnp.uint32)
    words = words.at[rows, w0].add(lo).at[rows, w0 + 1].add(hi)
    # end mark: one 1 bit just past the last code
    mark = jnp.uint32(1) << (total & 31).astype(jnp.uint32)
    words = words.at[jnp.arange(ns), total >> 5].add(mark)
    sizes = (total + 1 + 7) >> 3
    anchors = incl[:, K - 1 :: K][:, ::-1]
    return words[:, :WORDS], sizes, anchors


def decode_tables(lengths: np.ndarray):
    """lengths (256,) -> packed (1, 304) int32 decode table:
    [base(12) | n(12) | offset(12) | pad(4) | sorted_syms(256) | pad(8)].

    offset_l = rank of the first length-l code in the (length desc, symbol
    asc) sorted symbol list; base_l = first canonical code value of length
    l (0 when none)."""
    lengths = np.asarray(lengths, np.int32)
    base = np.zeros(12, np.int64)
    n = np.zeros(12, np.int64)
    off = np.zeros(12, np.int64)
    sorted_syms = []
    code = 0
    prev = MAX_BITS
    for ln in range(MAX_BITS, 0, -1):
        code >>= (prev - ln)
        prev = ln
        syms = np.nonzero(lengths == ln)[0]
        base[ln] = code
        n[ln] = len(syms)
        off[ln] = len(sorted_syms)
        sorted_syms.extend(int(s) for s in syms)
        code += len(syms)
    syms = np.zeros(256, np.int64)
    syms[: len(sorted_syms)] = sorted_syms
    out = np.zeros(304, np.int32)
    out[0:12] = base
    out[12:24] = n
    out[24:36] = off
    out[40:296] = syms
    return out.reshape(1, 304)


@jax.jit
def decode_streams_device(stream_bytes, anchors, tables):
    """stream_bytes (ns, L) uint8 Huffman bitstreams, zero-padded; anchors
    (ns, 256) int32 — bit read position of segment g's first symbol;
    tables (ns, 304) int32 from decode_tables. Returns (ns, 32768) uint8
    symbols (segments past a stream's last symbol decode garbage that the
    caller slices off)."""
    ns = stream_bytes.shape[0]
    sb = jnp.pad(stream_bytes.astype(jnp.int32), ((0, 0), (0, 3)))
    top = sb.shape[1] - 3
    base = tables[:, None, 1:12]
    nl = tables[:, None, 13:24]
    off = tables[:, None, 25:36]

    def read3(bidx):
        bidx = jnp.clip(bidx, 0, top)
        b = [jnp.take_along_axis(sb, bidx + k, axis=1) for k in range(3)]
        return b[0] | (b[1] << 8) | (b[2] << 16)

    def step(r, _):
        # 11-bit lookahead below the cursor, left-aligned when it hangs
        # below bit 0 near the stream bottom
        lo = jnp.maximum(r - 11, 0)
        v = read3(lo >> 3)
        w = ((v >> (lo & 7)) << jnp.maximum(11 - r, 0)) & 0x7FF
        ls = jnp.arange(1, 12, dtype=jnp.int32)
        cand = w[..., None] >> (11 - ls)
        hit = (cand >= base) & (cand < base + nl)
        first = hit & (jnp.cumsum(hit, axis=-1) == 1)  # shortest match
        ln = jnp.sum(jnp.where(first, ls, 0), axis=-1)
        rank = jnp.sum(jnp.where(first, off + cand - base, 0), axis=-1)
        return r - ln, rank

    _, ranks = jax.lax.scan(step, anchors, None, length=K)  # (K, ns, S)
    ranks = jnp.clip(ranks.transpose(1, 2, 0).reshape(ns, STREAM), 0, 255)
    syms = jnp.take_along_axis(tables[:, 40:296], ranks, axis=1)
    return syms.astype(jnp.uint8)
