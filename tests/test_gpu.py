"""GPU-only checks: skip on the CPU (the `gpu` fixture decides at run
time). `python chip_smoke.py` runs the same comparisons at full size."""

import pytest

import stenos_tpu as st
from stenos_tpu.engine_jax import JaxEngine

from conftest import gen_elements


@pytest.mark.gpu
@pytest.mark.parametrize("level", [1, 2])
def test_gpu_engine_matches_host(gpu, rng, level):
    data = gen_elements(rng, 4, (8 << 20) // 4, "sorted")
    assert isinstance(st.default_engine(), JaxEngine)
    frame = st.compress(data, 4, level, engine="auto")
    assert frame == st.compress(data, 4, level)
    assert st.decompress(frame, 4, engine="auto").tobytes() == data
