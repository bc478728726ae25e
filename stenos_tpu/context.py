"""Compression context & time-limited mode (stenos.h:90-173 API parity).

The reference's time-budget machinery (TimeConstraint, FindCLevel,
clevel_for_remaining — zstd_wrapper.h:39-171, block_compress.h:1024-1075)
adapts the block level per 256-element block and the zstd level per
superblock from wall-clock progress. The device engine processes a whole
superblock batch at once, so the controller runs at superblock granularity:
same decision functions, same rate tables, chunk-level adaptation, memcpy
self-rescue. Timing-dependent output is inherently non-reproducible in the
reference too; the format stays identical.
"""

import time

import numpy as np

from .constants import (
    MAX_BLOCK_BYTES,
    NO_BLOCK_SHIFT,
    compress_bound,
    super_block_size,
)

# zstd rate->level table (zstd_wrapper.h:95-101)
_RATES = [
    (1_000_000, 9), (5_000_000, 8), (7_000_000, 7), (9_000_000, 6),
    (20_000_000, 5), (40_000_000, 4), (60_000_000, 3), (230_000_000, 2),
    (300_000_000, 1),
]


def level_for_rate(rate: float, shift: int = 0) -> int:
    """zstd_wrapper.h:103-111."""
    for first, lvl in _RATES:
        if rate <= (first << shift):
            return lvl
    if rate > (_RATES[-1][0] << shift) * 1.5:
        return 0
    return 1


class TimeConstraint:
    def __init__(self, nanoseconds: int):
        self.nanoseconds = nanoseconds
        self.total_bytes = 0
        self.processed_bytes = 0
        self.finish_memcpy = False
        self.unsatisfiable = False  # budget below the measured warm floor
        self._t0 = 0.0

    def start(self, total_bytes: int):
        self.total_bytes = total_bytes
        self.processed_bytes = 0
        self.finish_memcpy = False
        self.unsatisfiable = False
        self._t0 = time.perf_counter_ns()

    def elapsed(self) -> int:
        return time.perf_counter_ns() - self._t0

    def requested_speed(self) -> float:
        remaining = (self.nanoseconds - self.elapsed()) * 1e-9
        if remaining <= 0:
            return float("inf")
        return (self.total_bytes - self.processed_bytes) / remaining


# Measured warm floor (ns) of one end-to-end timed call per backend kind
# ("engine" = device rounds, "host" = per-superblock loop): the fastest
# call seen in this process. A budget below it cannot be met — the
# reference's <=1 ms overshoot claim (stenos.h:152-154) has no device
# dispatch in it. frame.compress_generic records every timed call here and
# warns once when a requested budget is below the floor.
_timed_floor_ns: dict = {}


def timed_floor_ns(kind: str):
    return _timed_floor_ns.get(kind)


def record_timed_call(kind: str, elapsed_ns: int):
    prev = _timed_floor_ns.get(kind)
    if prev is None or elapsed_ns < prev:
        _timed_floor_ns[kind] = elapsed_ns


def clevel_for_remaining(t: TimeConstraint, processed: int,
                         target_rate=None, shift: int = 0) -> int:
    """zstd stage level controller (zstd_wrapper.h:118-171)."""
    el = t.elapsed()
    remaining = t.total_bytes - processed
    if el + remaining / 12 > t.nanoseconds:  # 12 GB/s memcpy floor
        t.finish_memcpy = True
        return 0
    rate = target_rate if target_rate is not None else (
        remaining / ((t.nanoseconds - el) * 1e-9))
    clevel = level_for_rate(rate, shift)
    if processed == 0:
        return max(clevel, 1)
    if clevel > 6:
        clevel = 6
    advance = processed / t.total_bytes
    advance_time = el / t.nanoseconds
    if advance > advance_time * 1.3:
        clevel += 1 + (advance > advance_time * 1.6) + (advance > advance_time * 2)
    elif advance < advance_time:
        clevel -= 1 + (advance * 1.6 < advance_time)
    if clevel == 9 and advance > 0.5 and rate > 1_000_000:
        clevel = 8
    if clevel < 1 and target_rate is None:
        factor = 0.5 + (1 - remaining / t.total_bytes) * 0.5
        if advance > advance_time * factor:
            clevel = 1
    return clevel


def find_block_level(t: TimeConstraint, consumed: int) -> int:
    """Chunk-granular FindCLevel (block_compress.h:1036-1074): 2/1/0 block
    level, -1 memcpy this chunk, -2 memcpy everything."""
    threshold = 2_000_000_000  # 2 GB/s
    consumed += t.processed_bytes
    remaining = t.total_bytes - consumed
    el = t.elapsed()
    ratio_bytes = consumed / t.total_bytes if t.total_bytes else 1.0
    ratio_time = el / t.nanoseconds
    if ratio_time < 0.2:
        denom = (t.nanoseconds - el) * 1e-9
        if denom > 0 and remaining / denom < threshold:
            return 2
    if ratio_time < 0.01 or consumed == 0:
        return 2
    if ratio_time > 0.5:
        if el + remaining / 16 > t.nanoseconds:  # 16 GB/s memcpy floor
            return -2
    if ratio_time > ratio_bytes * 3:
        return -1
    if ratio_time > ratio_bytes * 1.8:
        return 0
    if ratio_time > ratio_bytes * 1.4:
        return 1
    return 2


class Context:
    """stenos_context equivalent (stenos.h:90-173)."""

    def __init__(self, level: int = 1, threads: int = 1,
                 max_nanoseconds: int = 0,
                 blocksize_shift: int | None = None, engine=None):
        self.level = level
        self.threads = threads
        self.t = TimeConstraint(max_nanoseconds)
        self.blocksize_shift = blocksize_shift
        self.engine = engine
        self.superblock_size = 0

    # -- stenos_set_* parity
    def set_level(self, level: int):
        self.level = min(9, max(0, level))

    def set_threads(self, threads: int):
        self.threads = max(1, threads)

    def set_max_nanoseconds(self, ns: int):
        self.t.nanoseconds = ns

    def set_block_size(self, shift):
        if shift is not None and shift != NO_BLOCK_SHIFT and shift >= 16:
            raise ValueError("blocksize shift must be < 16")
        self.blocksize_shift = None if shift == NO_BLOCK_SHIFT else shift

    def reset(self):
        self.level = 1
        self.threads = 1
        self.t.nanoseconds = 0
        self.blocksize_shift = None

    def memory_footprint(self) -> int:
        return 3 * (self.superblock_size + 4)

    def warmup(self, bytesoftype: int, nbytes: int, max_r: int = 64,
               block_levels=(2,)):
        """Pre-compile the timed-mode round shapes for an input of
        ~nbytes — the device analog of the reference creating its thread
        pool at program init (stenos.cpp:755-764): afterwards no jit
        compile lands inside a time budget. One-time per machine (the
        persistent jit cache keeps the shapes across processes).

        Compiles one encode batch per power-of-two round size x block
        level for the superblock size prepare_superblock would pick."""
        if self.engine is None:
            return
        import numpy as np

        ns_saved = self.t.nanoseconds
        self.t.nanoseconds = self.t.nanoseconds or 1  # timed-mode sizing
        try:
            sb, _ = self.prepare_superblock(bytesoftype, nbytes)
        finally:
            self.t.nanoseconds = ns_saved
        r = 1
        while r <= max_r:
            batch = np.zeros(r * sb, np.uint8)
            for bl in block_levels:
                self.engine.encode_batch(batch, bytesoftype, sb,
                                         block_level=bl)
            r <<= 1

    def prepare_superblock(self, bpp: int, nbytes: int):
        """Superblock sizing incl. time-limited strategy (stenos.cpp:115-169)."""
        block_size = bpp * 256
        if self.t.nanoseconds:
            # aim for >= threads*32 superblocks (stenos.cpp:126-149);
            # the block count is bucketed to a power of two so the device
            # engine sees a BOUNDED set of batch shapes across input sizes
            # (a fresh shape = a jit compile inside the budget; frame.py
            # next_round_size buckets the round dimension the same way)
            bc = max((nbytes // max(self.threads * 32, 1)) // block_size, 1)
            bc = 1 << (bc.bit_length() - 1)
            sb = block_size * bc
            shift = 255
            if sb >= MAX_BLOCK_BYTES:
                sb = super_block_size(block_size)
                if nbytes > sb:
                    shift = 4  # level-9 default strategy
                    sb <<= 4
            elif sb < 131072:
                sb = super_block_size(block_size)  # shift stays 255
            self.superblock_size = sb
            return sb, shift
        from .frame import _superblock_params

        sb, shift = _superblock_params(bpp, nbytes, self.level,
                                       self.blocksize_shift)
        self.superblock_size = sb
        return sb, shift
