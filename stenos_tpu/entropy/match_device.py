"""Device-side LZ77 candidate discovery for the zstd sequences section.

Device replacement for the reference's sequential hash-chain walk
(libzstd inside zstd_wrapper.h:59-90): candidate discovery is expressed
entirely as batched stable SORTS plus elementwise ops, with no gathers or
scatters.

Per doubling level L = 4, 8, ..., 2^MAX_K: windows of length L are grouped
by sorting (group_id[i], group_id[i+L/1]) pairs; because the sort is
stable, each element's sorted-order predecessor with an equal key pair IS
its nearest earlier occurrence, and a cumsum over group boundaries yields
the next level's ids (suffix-array doubling, equality-only). The result is
a per-position candidate (distance, k) with a GUARANTEED match of 2^k
bytes — a floor, not the exact length: the exact greedy extension is O(n)
scalar work done by the native C++ walk (stn_match_parse) that consumes
this array, or by the numpy fallback below.

One dispatch covers a whole batch of 128 KiB blocks ((B, N) arrays, sorts
along the minor axis); batch sizes are bucketed to powers of two to bound
compile count.
"""

import functools

import numpy as np

MIN_K = 2          # first level: 4-byte windows (zstd MIN_MATCH analog)
MAX_K = 12         # guaranteed-length cap 4096 (exact extension is unbounded)

CAND_DIST_MASK = 0x00FFFFFF  # low 24 bits: distance; bits 24..27: k


def _candidates_impl(blocks, max_k: int = MAX_K):
    import jax.numpy as jnp
    from jax import lax

    B, N = blocks.shape
    iota = lax.broadcasted_iota(jnp.int32, (B, N), 1)
    b32 = blocks.astype(jnp.int32)

    # 4-byte fingerprints: the EXACT window content packed into an int32
    # (equality of keys <=> equality of windows; sort order is irrelevant)
    def shift(a, k, fill):
        return jnp.where(iota + k < N, jnp.roll(a, -k, axis=1), fill)

    fp = (b32 | (shift(b32, 1, 0) << 8) | (shift(b32, 2, 0) << 16)
          | (shift(b32, 3, 0) << 24))
    # positions whose 4-byte window runs off the block get UNIQUE key pairs
    # so they join no group (and their group ids stay unique at all levels)
    invalid = iota + 4 > N
    key1 = fp
    key2 = jnp.where(invalid, iota + 1, 0)

    cand = jnp.zeros((B, N), jnp.int32)
    k = MIN_K
    while True:
        k1s, k2s, ps = lax.sort((key1, key2, iota), dimension=1,
                                is_stable=True, num_keys=2)
        prev1 = jnp.roll(k1s, 1, axis=1)
        prev2 = jnp.roll(k2s, 1, axis=1)
        first = lax.broadcasted_iota(jnp.int32, (B, N), 1) == 0
        same = (~first) & (k1s == prev1) & (k2s == prev2)
        # stable sort => within a group, positions ascend: the predecessor
        # is the nearest EARLIER occurrence of this window
        dist_s = jnp.where(same, ps - jnp.roll(ps, 1, axis=1), 0)
        gid_s = jnp.cumsum((~same).astype(jnp.int32), axis=1)
        # unpermute to position order (again a sort — no scatters)
        _, dist_p, gid_p = lax.sort((ps, dist_s, gid_s), dimension=1,
                                    is_stable=False, num_keys=1)
        cand = jnp.where(dist_p > 0, dist_p | (k << 24), cand)
        if k >= max_k:
            break
        # next level: pair each window's id with the id L bytes later;
        # ids are in [1, N], so N + 1 + iota is a unique invalid code
        L = 1 << k
        key1 = gid_p
        key2 = shift(gid_p, L, N + 1 + iota)
        k += 1
    return cand


@functools.lru_cache(maxsize=None)
def _candidates_jit():
    import jax

    return jax.jit(_candidates_impl, static_argnames=("max_k",))


def _matchiness_impl(blocks):
    """(B, N) uint8 -> (B,) fraction of positions whose 4-byte window
    already occurred in the block (duplicate 4-grams = LZ potential).
    One stable sort — the cheap routing prepass before the full pipeline."""
    import jax.numpy as jnp
    from jax import lax

    B, N = blocks.shape
    iota = lax.broadcasted_iota(jnp.int32, (B, N), 1)
    b32 = blocks.astype(jnp.int32)

    def shift(a, k):
        return jnp.where(iota + k < N, jnp.roll(a, -k, axis=1), 0)

    fp = (b32 | (shift(b32, 1) << 8) | (shift(b32, 2) << 16)
          | (shift(b32, 3) << 24))
    key2 = jnp.where(iota + 4 > N, iota + 1, 0)
    k1s, k2s = lax.sort((fp, key2), dimension=1, is_stable=False,
                        num_keys=2)
    same = (k1s == jnp.roll(k1s, 1, axis=1)) \
        & (k2s == jnp.roll(k2s, 1, axis=1)) \
        & (lax.broadcasted_iota(jnp.int32, (B, N), 1) > 0)
    return jnp.mean(same.astype(jnp.float32), axis=1)


@functools.lru_cache(maxsize=None)
def _matchiness_jit():
    import jax

    return jax.jit(_matchiness_impl)


def matchiness(blocks) -> np.ndarray:
    """Duplicate-4-gram fraction per block, computed on device."""
    import jax.numpy as jnp

    blocks = np.ascontiguousarray(blocks, np.uint8)
    if blocks.ndim == 1:
        blocks = blocks[None]
    return np.asarray(_matchiness_jit()(jnp.asarray(blocks)))


def match_candidates(blocks, max_k: int = MAX_K) -> np.ndarray:
    """blocks: (B, N) uint8 -> (B, N) int32 packed candidates.

    Entry i holds dist | (k << 24) where the 2^k-byte windows at i and
    i - dist are bit-identical (largest such k per position, nearest such
    earlier occurrence at that k), or 0 when position i opens no match.
    """
    import jax.numpy as jnp

    blocks = np.ascontiguousarray(blocks, np.uint8)
    if blocks.ndim == 1:
        blocks = blocks[None]
    return np.asarray(_candidates_jit()(jnp.asarray(blocks), max_k=max_k))


def parse_from_candidates(data: np.ndarray, cand: np.ndarray,
                          min_gain: int = 4, reps=(1, 4, 8)):
    """Greedy cursor walk over a candidate array -> (seqs, literals) in the
    encode_sequences contract, or None when matching isn't worthwhile.

    Native C++ (stn_match_parse) when available — the walk is O(n) scalar
    with exact match extension, the wrong shape for the vector units but
    trivial for a host core. Numpy/python fallback otherwise.
    """
    from ..native import lib as native

    if native is not None and hasattr(native, "match_parse"):
        return native.match_parse(data, cand, reps=reps)
    return _parse_py(data, cand, min_gain, reps=reps)


REP_GAIN = 2       # rep match wins when within this many bytes of the best
REP_MIN = 4        # minimum usable repeat-offset match length


def rep_best(data, p: int, reps, n: int, ml_cap: int):
    """Longest extension at the current repeat-offset registers from p
    (0 when none reaches REP_MIN). Register order breaks ties (reps[0]
    first, strict >), so both twins are deterministic."""
    best_rl = 0
    best_rep = 0
    for r in reps:
        if r <= 0 or r > p:
            continue
        l = 0
        while p + l < n and data[p + l] == data[p + l - r] and l < ml_cap:
            l += 1
        if l > best_rl:
            best_rl, best_rep = l, r
    return best_rep, best_rl


def rep_update(reps, ll: int, d: int):
    """Recent-offset register update for one emitted sequence — the exact
    _recode_repeat_offsets rule (libzstd ZSTD_updateRep), tracked during
    the walk so rep preference sees the registers the CODER will have."""
    if ll != 0:
        code = 1 if d == reps[0] else 2 if d == reps[1] \
            else 3 if d == reps[2] else 0
    else:
        code = 1 if d == reps[1] else 2 if d == reps[2] \
            else 3 if d == reps[0] - 1 else 0
    if code == 0:
        return [d, reps[0], reps[1]]
    ri = code - 1 + (1 if ll == 0 else 0)
    if ri == 1:
        return [reps[1], reps[0], reps[2]]
    if ri == 2:
        return [reps[2], reps[0], reps[1]]
    if ri == 3:
        return [reps[0] - 1, reps[0], reps[1]]
    return list(reps)


def _parse_py(data: np.ndarray, cand: np.ndarray, min_gain: int = 4,
              reps=(1, 4, 8)):
    """Reference implementation of the candidate walk (kept simple; the
    native twin must produce byte-identical parses — tested).

    Rep-aware (VERDICT r3 item 8): after the greedy/lazy pick, a match at
    one of the running repeat-offset registers is preferred when it is
    within REP_GAIN bytes of the candidate length — its offset channel
    costs ~1-2 FSE bits instead of log2(d) extra bits (libzstd's greedy
    rep-priority heuristic, the main records-family size gap)."""
    n = len(data)
    pos_all = np.flatnonzero(cand)
    if not len(pos_all):
        return None

    def extend(p):
        d = int(cand[p]) & CAND_DIST_MASK
        g = 1 << (int(cand[p]) >> 24)
        l = g if p + g <= n else n - p
        while p + l < n and data[p + l] == data[p + l - d]:
            l += 1
        return d, l

    seqs = []
    lit_parts = []
    cursor = 0
    total_matched = 0
    reps = list(reps)
    while True:
        i = np.searchsorted(pos_all, cursor, side="left")
        if i >= len(pos_all):
            break
        p = int(pos_all[i])
        d, l = extend(p)
        # lazy depth-1: prefer a materially longer match one byte later
        if i + 1 < len(pos_all) and int(pos_all[i + 1]) == p + 1:
            d1, l1 = extend(p + 1)
            if l1 > l + 3:
                p, d, l = p + 1, d1, l1
        rr, rl = rep_best(data, p, reps, n, 1 << 40)
        if rl >= REP_MIN and rl + REP_GAIN >= l:
            d, l = rr, rl
        ll = p - cursor
        lit_parts.append(data[cursor:p])
        seqs.append((ll, d + 3, l))
        total_matched += l
        reps = rep_update(reps, ll, d)
        cursor = p + l
    if not seqs or total_matched < max(64, n // 64):
        return None
    lit_parts.append(data[cursor:])
    lits = np.concatenate(lit_parts) if lit_parts else np.zeros(0, np.uint8)
    return seqs, lits
