import os

# Tests run the JAX engine on a virtual 8-device CPU mesh; the GPU path runs
# in chip_smoke.py. Pin the CPU platform before any backend initializes.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
if "parallel_codegen" not in flags:
    # long cold-cache suite runs intermittently segfaulted inside XLA:CPU's
    # parallel LLVM codegen; single-threaded codegen trades a little
    # compile time for determinism
    flags = (flags + " --xla_cpu_parallel_codegen_split_count=1").strip()
os.environ["XLA_FLAGS"] = flags

import jax

from stenos_tpu.utils.cache import use_compile_cache

jax.config.update("jax_platforms", "cpu")
# CPU XLA compiles of the unrolled log-shift graphs are slow; persist them.
use_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

import numpy as np
import pytest

from _gen import gen_elements  # noqa: F401  (tests import it from here)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(12345)


@pytest.fixture
def gen():
    return gen_elements


@pytest.fixture
def gpu():
    """The first JAX device, when it is a GPU; skips otherwise. Decided
    here, at run time, never at import: xdist workers must collect the
    same tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX's device is {dev.platform}); "
                    "run `python chip_smoke.py` on the card")
    return dev


@pytest.fixture(scope="session")
def ref():
    """The C++ reference oracle (tests/_oracle.py) when its sources are
    present (STENOS_REFERENCE_DIR), else None: parity tests then compare
    with the committed digests only."""
    import _oracle

    return _oracle if _oracle.available() else None


@pytest.fixture(scope="session")
def digests():
    """Committed host-path frame digests of the parity grid."""
    import _parity_cases

    return _parity_cases.load_digests()
