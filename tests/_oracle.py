"""ctypes binding to the C++ reference library, built from the sources in
the directory named by STENOS_REFERENCE_DIR.

Used ONLY by tests/benches as a correctness oracle: golden frames, interop
(our decoder on reference frames, reference decoder on our frames) and
compressed-size parity. The framework itself never depends on this. Where
the sources are absent, the parity tests compare against the committed
digests in tests/data/parity_digests.json instead (tests/_parity_cases.py).
"""

import ctypes
import glob
import hashlib
import os
import subprocess
import tempfile

_LIB = None


def _sources():
    ref = os.environ.get("STENOS_REFERENCE_DIR", "")
    if not ref:
        return ref, []
    return ref, sorted(glob.glob(os.path.join(ref, "stenos/internal/*.cpp")))


def available() -> bool:
    """True when the reference sources are present (the oracle can run)."""
    return bool(_sources()[1])


def _build(libpath: str) -> None:
    ref, srcs = _sources()
    if not srcs:
        raise RuntimeError("no reference sources: set STENOS_REFERENCE_DIR")
    os.makedirs(os.path.dirname(libpath), exist_ok=True)
    with tempfile.TemporaryDirectory() as td:
        cfg = os.path.join(td, "stenos_config.h")
        with open(cfg, "w") as f:
            f.write(
                "#ifndef STENOS_CONFIG_HPP\n#define STENOS_CONFIG_HPP\n"
                "#define STENOS_VERSION_MAJOR 0\n#define STENOS_VERSION_MINOR 2\n"
                '#define STENOS_VERSION "0.2"\n#endif\n'
            )
        tmp = f"{libpath}.tmp.{os.getpid()}.so"
        cmd = (
            ["g++", "-O2", "-march=native", "-std=c++14", "-DNDEBUG", "-shared", "-fPIC",
             f"-I{td}", f"-I{ref}", "-DSTENOS_BUILD_SHARED_LIBRARY"]
            + srcs
            + ["-lzstd", "-o", tmp]
        )
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, libpath)


def get_lib():
    """Build (if needed) and load the reference shared library. Raises when
    the sources are absent or the library exports no stenos API."""
    global _LIB
    if _LIB is not None:
        return _LIB
    _, srcs = _sources()
    if not srcs:
        raise RuntimeError("no reference sources: set STENOS_REFERENCE_DIR")
    h = hashlib.sha256()
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    libpath = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", f"stenos_oracle_{h.hexdigest()[:16]}.so")
    if not os.path.exists(libpath):
        _build(libpath)
    lib = ctypes.CDLL(libpath)
    if not hasattr(lib, "stenos_compress"):
        raise RuntimeError(f"{libpath} exports no stenos_compress")
    lib.stenos_compress.restype = ctypes.c_size_t
    lib.stenos_compress.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
    ]
    lib.stenos_decompress.restype = ctypes.c_size_t
    lib.stenos_decompress.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_size_t,
    ]
    lib.stenos_bound.restype = ctypes.c_size_t
    lib.stenos_bound.argtypes = [ctypes.c_size_t]
    _LIB = lib
    return lib


def has_error(r: int) -> bool:
    return r >= (2**64 - 100)


def bound(nbytes: int) -> int:
    return get_lib().stenos_bound(nbytes)


_SCRIBBLE = bytes((i * 197 + 31) & 255 for i in range(8192))


def _stabilize_lz_slot(lib):
    """The reference's level-1 intra-block LZ hashes into an UNINITIALIZED
    stack slot (block_compress.h:1211, NOTES.md 'reference bugs'): its
    content depends on whatever the process stack held — jax/XLA activity
    earlier in a test worker can leave garbage where a bogus candidate
    validates, making level-1 parity nondeterministic (observed once in
    ~7k fuzz iterations + one full-suite run). A level-2 compress runs
    lz4_guess_ratio first, which scribbles that slot with positions from
    THIS high-entropy buffer (they never validate as candidates for later
    inputs), so every level-1 oracle call starts from the same state our
    twin models."""
    cap = lib.stenos_bound(len(_SCRIBBLE))
    dst = ctypes.create_string_buffer(cap)
    lib.stenos_compress(_SCRIBBLE, 4, len(_SCRIBBLE), dst, cap, 2)


def compress(data: bytes, bytesoftype: int, level: int) -> bytes:
    lib = get_lib()
    if level == 1:
        _stabilize_lz_slot(lib)
    # exactly stenos_bound: method selection depends on the remaining dst
    # capacity (e.g. zstd is skipped when dstCapacity < srcSize + zstd
    # overhead, stenos.cpp serial path), so parity requires BOTH sides to
    # see the same capacity — our compress() defaults to the same bound
    cap = bound(len(data))
    dst = ctypes.create_string_buffer(cap)
    r = lib.stenos_compress(data, bytesoftype, len(data), dst, cap, level)
    if has_error(r):
        raise RuntimeError(f"oracle compress error code {2**64 - r}")
    return dst.raw[:r]


def compress_with_capacity(data: bytes, bytesoftype: int, level: int,
                           dst_size: int):
    """Reference compress into an EXACT capacity, with sentinel canaries
    after the buffer (tests_comp_decomp.cpp:93-113 behavior). Returns the
    frame bytes or the negative error code."""
    lib = get_lib()
    canary = b"\xa5" * 64
    dst = ctypes.create_string_buffer(max(dst_size, 0) + 64)
    dst.raw  # materialize
    ctypes.memmove(ctypes.addressof(dst) + max(dst_size, 0), canary, 64)
    r = lib.stenos_compress(data, bytesoftype, len(data), dst,
                            max(dst_size, 0), level)
    tail = ctypes.string_at(ctypes.addressof(dst) + max(dst_size, 0), 64)
    assert tail == canary, "reference wrote past dst capacity"
    if has_error(r):
        return -(2**64 - r)
    return dst.raw[:r]


def decompress(frame: bytes, bytesoftype: int, dst_size: int) -> bytes:
    lib = get_lib()
    dst = ctypes.create_string_buffer(dst_size + 64)
    r = lib.stenos_decompress(frame, bytesoftype, len(frame), dst, dst_size)
    if has_error(r):
        raise RuntimeError(f"oracle decompress error code {2**64 - r}")
    return dst.raw[:r]
