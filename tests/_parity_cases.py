"""The parity grid shared by the oracle tests (test_frame_parity.py,
test_shrinking_dst.py) and tools/gen_parity_digests.py.

Every case seeds its own generator from its parameters, so its data does
not depend on which tests ran before it in a worker. Where the C++
reference is absent, the tests compare each host-path frame with the
SHA-256 digest committed in tests/data/parity_digests.json; the host path
matched the reference byte for byte over this grid when the digests were
made.
"""

import hashlib
import json
import os
import zlib

import numpy as np

from _gen import gen_elements

DIGESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "parity_digests.json")

# full element-size sweep like the reference (tests_comp_decomp.cpp:181-216
# sweeps 1-15; we add 16): the format's interesting corners live at the odd
# widths (5,6,7,9,10,11,13,14,15)
ALL_BPP = list(range(1, 17))
KINDS = ["sorted", "random", "same", "rle", "smallrange"]
MID_LEVELS = [3, 4, 6, 7, 8]
SHRINK_BPP = [1, 3, 4, 8]
SHRINK_KINDS = ["sorted", "random", "rle"]
SHRINK_LEVELS = [1, 2, 5]
BOUND_SIZES = [0, 1, 1000, 65792, 65793, 10**7]


def case_rng(*params):
    return np.random.default_rng(
        zlib.crc32("/".join(map(str, params)).encode()))


def sha(frame) -> str:
    return hashlib.sha256(bytes(frame)).hexdigest()


def load_digests() -> dict:
    with open(DIGESTS) as f:
        return json.load(f)


def bit_exact_cases(kind, bpp):
    """(key, data, level) over sizes incl. partial blocks x levels."""
    for ne in [0, 1, 100, 5000, 70001]:
        data = gen_elements(case_rng("bit_exact", kind, bpp, ne), bpp, ne,
                            kind)
        for level in [0, 1, 2, 5, 9]:
            yield f"bit_exact/{kind}/{bpp}/{ne}/{level}", data, level


def mid_level_cases(level, bpp):
    """Mid levels exercise the superblock shift growth, the transposed-LZ
    estimators and the higher zstd levels of the decision tree."""
    for kind in ["sorted", "random", "rle"]:
        for ne in [5000, 70001]:
            data = gen_elements(case_rng("mid", kind, bpp, ne), bpp, ne,
                                kind)
            yield f"mid/{level}/{kind}/{bpp}/{ne}", data, level


def lz_pool_bytes(seed, n):
    """Match-rich bytes: 64-byte rows drawn from a pool of 37."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 64, (37, 64), np.uint8)
    idx = rng.integers(0, 37, n // 64 + 1)
    return pool[idx].reshape(-1)[:n].tobytes()


def lz_table_cases():
    """Data whose LZ escapes depend on the hash table carrying over between
    blocks and (level 1) superblocks."""
    from stenos_tpu.constants import super_block_size

    rng = np.random.default_rng(5262529557974360290)
    pool = rng.integers(0, 64, (37, 64), np.uint8)
    for bpp, n_sb in ((4, 1), (8, 1), (16, 3)):
        sb = super_block_size(256 * bpp)
        n = sb * n_sb + 1792
        idx = rng.integers(0, 37, n // 64 + 1)
        data = pool[idx].reshape(-1)[:n].tobytes()
        yield f"lz_table/{bpp}/{n_sb}", data, bpp


def lz_tail_case():
    """One full block + partial tail at bpp 16, < one superblock."""
    return "lz_tail", lz_pool_bytes(3428548311448695019, 4096 + 1792), 16


def shrink_data(bpp, kind, level):
    return gen_elements(case_rng("shrink", bpp, kind, level), bpp,
                        150000 // bpp, kind)


def shrink_sizes(full_len):
    """dst capacities from just past the full frame down to zero."""
    return sorted(set(
        list(range(full_len + 2, max(full_len - 6, 0), -1))
        + [full_len * 3 // 4, full_len // 2, full_len // 4,
           32, 12, 8, 4, 1, 0]), reverse=True)


def shrink_parity_data():
    return gen_elements(case_rng("shrink_parity"), 4, 60000, "sorted")


def shrink_parity_sizes(full_len):
    return [full_len + 1, full_len, full_len - 1, full_len * 7 // 8]
