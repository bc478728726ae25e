"""Bit-exact parity and interop vs the C++ reference (oracle).

Mirrors the reference codec sweep (tests_comp_decomp.cpp) with the added
requirement that compressed frames are byte-identical, and both decoders
accept each other's frames. Every frame is compared with its committed
digest (tests/_parity_cases.py); with the reference present
(STENOS_REFERENCE_DIR), with the reference's own frame too.
"""

import pytest

import stenos_tpu as st
import _parity_cases as pc
from _parity_cases import ALL_BPP, KINDS, MID_LEVELS, sha


def _check(key, data, bpp, level, ref, digests):
    mine = st.compress(data, bpp, level)
    assert sha(mine) == digests["frames"][key], key
    assert st.decompress(mine, bpp).tobytes() == data
    if ref is not None:
        r = ref.compress(data, bpp, level)
        assert mine == r, key
        assert st.decompress(r, bpp).tobytes() == data
        assert ref.decompress(mine, bpp, len(data)) == data
    return mine


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("bpp", ALL_BPP)
def test_frame_bit_exact(kind, bpp, ref, digests):
    for key, data, level in pc.bit_exact_cases(kind, bpp):
        _check(key, data, bpp, level, ref, digests)


@pytest.mark.parametrize("level", MID_LEVELS)
@pytest.mark.parametrize("bpp", ALL_BPP)
def test_frame_bit_exact_mid_levels(level, bpp, ref, digests):
    """Mid levels exercise the superblock shift growth, the transposed-LZ
    estimators and the higher zstd levels of the decision tree."""
    for key, data, level in pc.mid_level_cases(level, bpp):
        _check(key, data, bpp, level, ref, digests)


def test_exact_superblock_multiple_decodes(rng):
    """The reference decoder rejects exact superblock multiples
    (stenos.cpp:1131 latent bug); our decoder must handle them."""
    from conftest import gen_elements

    data = gen_elements(rng, 4, 131072 // 4, "sorted")
    assert len(data) == 131072
    frame = st.compress(data, 4, 1)
    assert st.decompress(frame, 4).tobytes() == data
    # two full superblocks
    data2 = gen_elements(rng, 4, 262144 // 4, "sorted")
    frame2 = st.compress(data2, 4, 2)
    assert st.decompress(frame2, 4).tobytes() == data2


def test_get_info(rng):
    from conftest import gen_elements

    data = gen_elements(rng, 4, 100000, "sorted")
    frame = st.compress(data, 4, 3)
    dsize, sb, hlen = st.get_info(frame, 4)
    assert dsize == len(data)
    assert hlen == 8
    assert sb == st.super_block_size(1024) << 1  # level 3 -> shift 1


def test_bound(ref, digests):
    for n in pc.BOUND_SIZES:
        assert st.compress_bound(n) == digests["bound"][str(n)]
        if ref is not None:
            assert st.compress_bound(n) == ref.bound(n)


def test_lz_table_persists_across_blocks(ref, digests):
    """Match-rich data whose LZ escapes depend on the hash table carrying
    over BETWEEN blocks — and, at level 1, between SUPERBLOCKS: the
    reference's table is a per-iteration stack slot that survives its
    block loop (block_compress.h:1211) and, single-threaded at level 1,
    the whole frame (found by tools/fuzz_parity.py; NOTES.md). The table
    is frame-scoped at level 1 here, so multi-superblock frames must be
    bit-exact too."""
    for key, data, bpp in pc.lz_table_cases():
        _check(key, data, bpp, 1, ref, digests)


def test_lz_budget_covers_partial_tail(ref, digests):
    """A short superblock (one full block + partial tail): the LZ escape's
    dst-room precondition must budget the SUPERBLOCK's total input size
    (the reference passes it as dst_size, stenos.cpp:547) — budgeting only
    the full-block region suppressed the attempt and the frame fell back
    to COPY, 8% larger than the reference (fuzz seed 3428548311448695019)."""
    key, data, bpp = pc.lz_tail_case()
    mine = _check(key, data, bpp, 1, ref, digests)
    assert mine[8] == 1, "expected method BLOCK, not COPY"
