"""Zstd entropy stage via the system libzstd (ctypes).

The reference links libzstd directly (zstd_wrapper.h); binding the same
system library gives byte-identical zstd frames, which keeps method-selection
and size parity exact. The device entropy stage (entropy/) is the opt-in
alternative; this module stays the default and the interop validator.
"""

import ctypes
import ctypes.util

import numpy as np

_lib = None


def _zstd():
    global _lib
    if _lib is None:
        name = ctypes.util.find_library("zstd") or "libzstd.so.1"
        lib = ctypes.CDLL(name)
        lib.ZSTD_compressCCtx.restype = ctypes.c_size_t
        lib.ZSTD_compressCCtx.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
        ]
        lib.ZSTD_createCCtx.restype = ctypes.c_void_p
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        lib.ZSTD_decompress.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
        ]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        lib.ZSTD_getErrorCode.restype = ctypes.c_int
        lib.ZSTD_getErrorCode.argtypes = [ctypes.c_size_t]
        lib.ZSTD_compressBound.restype = ctypes.c_size_t
        lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
        lib.ZSTD_maxCLevel.restype = ctypes.c_int
        _lib = lib
    return _lib


_tls = None


def _cctx():
    """Per-THREAD ZSTD_CCtx: a CCtx is not thread-safe, and the frame
    layer fans superblocks out over a thread pool (frame.compress
    threads>1) — a shared context segfaulted under that load."""
    global _tls
    import threading

    if _tls is None:
        _tls = threading.local()
    ctx = getattr(_tls, "cctx", None)
    if ctx is None:
        ctx = _zstd().ZSTD_createCCtx()
        _tls.cctx = ctx
    return ctx


def zstd_from_reduced_level(clevel: int) -> int:
    """stenos level (0..9) -> zstd level (zstd_wrapper.h:49-56)."""
    if clevel < 1:
        return 1
    if clevel < 9:
        return clevel * 2 - 1
    return _zstd().ZSTD_maxCLevel()


# ZSTD error code for dstSize_tooSmall (zstd_errors.h)
_DST_TOO_SMALL = 70


def compress(data, capacity: int, stenos_level: int):
    """Returns compressed bytes, or 'overflow'/'error' strings on failure
    (mirroring STENOS_ERROR_DST_OVERFLOW / _ZSTD_INTERNAL).

    The output buffer is capped at ZSTD_compressBound: zstd never writes
    more, and callers pass the whole frame's remaining capacity, which an
    allocation per call would have to zero."""
    lib = _zstd()
    data = bytes(data)
    cap = min(max(capacity, 0), lib.ZSTD_compressBound(len(data)))
    dst = np.empty(max(cap, 1), np.uint8)
    r = lib.ZSTD_compressCCtx(
        _cctx(), dst.ctypes.data, cap, data, len(data),
        zstd_from_reduced_level(stenos_level),
    )
    if lib.ZSTD_isError(r):
        if lib.ZSTD_getErrorCode(r) == _DST_TOO_SMALL:
            return "overflow"
        return "error"
    return dst[:r].tobytes()


def decompress(src, dst_size: int):
    """Decompress into at most dst_size bytes; None on error. The buffer is
    not zero-filled: callers pass generous bounds (a superblock's maximum
    size), and only the bytes zstd writes are returned."""
    lib = _zstd()
    src = bytes(src)
    dst = np.empty(max(dst_size, 1), np.uint8)
    r = lib.ZSTD_decompress(dst.ctypes.data, dst_size, src, len(src))
    if lib.ZSTD_isError(r):
        return None
    return dst[:r].tobytes()
