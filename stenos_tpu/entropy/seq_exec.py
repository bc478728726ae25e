"""Device executor for zstd sequence copy-op programs.

The host decodes each block's sequences in O(nseq) (native stn_zstd_seqs)
and compiles them into a W-chunked copy-op program (stn_seq_ops): pairs
(dst, src) into ONE flat device buffer laid out as

    [ output area | literal area | per-lane scratch ]

Every op copies exactly W contiguous bytes; programs are destination-
ordered and rely on ordered overwrite — only the bytes up to the next
op's dst must be correct, the tail is overwritten later (the W-padding
past the frame end lands in dedicated slack).

Execution is vectorized in ROUNDS: round i executes op i of every lane
(lane = one zstd block for our frames, whose matches never cross block
boundaries — entropy/match.py MAX_OFFSET; lane = the whole frame for
foreign frames with cross-block matches). A round is one W-slice gather +
one W-slice scatter over the flat buffer, so the bulk runs at memory speed
and per-op control overhead is amortized over the lane count.

Reference behavior matched: the zstd sequence-execution loop inside
ZSTD_decompressBlock (stenos.cpp:694-753 routes all method 2/3/4/5
payloads through it); RFC 8878 §3.1.1.4.
"""

import functools

import jax
import numpy as np


def _bucket(n: int, lo: int = 8) -> int:
    """Next power of two >= n (>= lo): every distinct (L, R, total) shape
    is a fresh XLA compile, so program and buffer dims snap to buckets
    that real frames reuse."""
    n = max(n, lo)
    return 1 << (n - 1).bit_length()


def pack_programs(progs, buf_len: int, W: int):
    """progs: list over lanes of (nops, 2) int arrays with ABSOLUTE
    dst/src byte offsets into the flat buffer (literal ops already
    rebased into the literal area). Pads every lane to the bucketed op
    count with ops that copy buffer[0:W] into that lane's scratch slot,
    and pads the lane count with all-pad lanes.

    Returns (dst (L, R) int32, src (L, R) int32, total_len) where
    total_len = bucketed(buf_len + L*W scratch + W slack)."""
    L = _bucket(len(progs), lo=1)
    R = _bucket(max((len(p) for p in progs), default=0))
    dst = np.empty((L, R), np.int32)
    src = np.zeros((L, R), np.int32)
    for i in range(L):
        dst[i, :] = buf_len + i * W
    for i, p in enumerate(progs):
        if len(p):
            dst[i, : len(p)] = p[:, 0]
            src[i, : len(p)] = p[:, 1]
    # buffer length: sub-octave rounding (4 shapes per power of two,
    # <=12.5% slack) instead of pow2 to avoid doubling HBM at 100s of MB
    need = buf_len + L * W + W
    grain = max(1 << 16, 1 << (max(need - 1, 1).bit_length() - 3))
    return dst, src, -(-need // grain) * grain


@functools.partial(jax.jit, static_argnames=("W",))
def run_programs(buf, dst, src, W: int):
    """buf: (total_len,) uint8 flat buffer (output area zero-filled, the
    literal area populated). dst/src: (L, R) int32 from pack_programs.
    Executes R rounds; returns the updated buffer."""
    from jax import lax

    L, R = dst.shape

    def gather_w(b, starts):
        return jax.vmap(
            lambda s: lax.dynamic_slice_in_dim(b, s, W))(starts)

    dnums = lax.ScatterDimensionNumbers(
        update_window_dims=(1,),
        inserted_window_dims=(),
        scatter_dims_to_operand_dims=(0,),
    )

    def round_(i, b):
        chunks = gather_w(b, src[:, i])
        return lax.scatter(
            b, dst[:, i, None], chunks, dnums,
            indices_are_sorted=False, unique_indices=True,
            mode=lax.GatherScatterMode.CLIP)

    return lax.fori_loop(0, R, round_, buf)


def run_programs_numpy(buf, dst, src, W: int):
    """Reference executor (tests / host fallback)."""
    buf = np.array(buf, np.uint8)
    L, R = dst.shape
    for i in range(R):
        for l in range(L):
            s, d = int(src[l, i]), int(dst[l, i])
            buf[d : d + W] = buf[s : s + W].copy()  # snapshot, like the kernel
    return buf
