"""stenos-tpu: a JAX lossless codec framework for binary structured data,
format-compatible with the C++ `stenos` library.

Public API mirrors stenos.h: `compress`, `decompress`, `get_info`,
`compress_bound`, plus the array-level `CompressedArray` container (cvector
equivalent) and device/sharded engines under `stenos_tpu.engine_jax` /
`stenos_tpu.parallel`.
"""

from .constants import compress_bound, super_block_size
from .container import CompressedArray
from .device_container import DeviceCompressedArray
from .context import Context
from .frame import (
    StenosError,
    compress,
    compress_generic,
    decompress,
    decompress_generic,
    get_info,
)
from .utils.timer import Timer


def has_error(code) -> bool:
    """stenos_has_error parity: negative size results are error codes."""
    try:
        return int(code) < 0
    except (TypeError, ValueError):
        return isinstance(code, StenosError)

__version__ = "0.1.0"


def default_engine():
    """Backend selection — the analog of the reference's CPUID runtime
    dispatch (simd.h:199-258): JaxEngine when JAX's default device is an
    accelerator, the native-C++/numpy host path otherwise (None)."""
    import jax

    if jax.devices()[0].platform != "cpu":
        from .engine_jax import JaxEngine

        return JaxEngine()
    return None


def compress_sharded(data, bytesoftype: int, level: int = 1,
                     mesh=None) -> bytes:
    """Multi-device frame compression over a device mesh (see
    parallel/api.py); also reachable as compress(..., mesh=mesh)."""
    from .parallel.api import compress_sharded as _cs

    return _cs(data, bytesoftype, level, mesh)


def decompress_sharded(frame, bytesoftype: int, mesh=None):
    """Multi-device frame decompression over a device mesh (see
    parallel/api.py); also reachable as decompress(..., mesh=mesh)."""
    from .parallel.api import decompress_sharded as _ds

    return _ds(frame, bytesoftype, mesh)


__all__ = [
    "CompressedArray",
    "DeviceCompressedArray",
    "Context",
    "compress",
    "compress_generic",
    "compress_sharded",
    "decompress",
    "decompress_generic",
    "decompress_sharded",
    "get_info",
    "has_error",
    "Timer",
    "compress_bound",
    "super_block_size",
    "StenosError",
    "__version__",
]
