"""General-offset LZ77 match finding for the zstd sequences section.

Vector-shaped design: instead of the reference's
sequential hash-chain walk (libzstd inside zstd_wrapper.h:59-90), candidate
discovery is a SORT — positions keyed by the 4-byte fingerprint at each
offset; equal fingerprints become neighbors, and the previous element in a
(hash, position)-sorted order is exactly the nearest earlier occurrence.
Everything except the final greedy cursor walk is vectorized (numpy here,
lax.sort on device for the bulk path), and the cursor walk itself is
O(#sequences) with searchsorted jumps, not O(n).

Output contract matches sequences.encode_sequences: (literal_length,
offset_value = offset + 3, match_length >= 3) triples + the literal bytes.
"""

import numpy as np

MIN_MATCH = 4        # fingerprint width; emitted matches are >= 4 bytes
MAX_OFFSET = 1 << 17  # within-block matches only (128 KiB blocks)


def _fingerprints(data: np.ndarray) -> np.ndarray:
    """u32 view of every 4-byte window (length n-3)."""
    n = len(data)
    a = data.astype(np.uint32)
    return (a[: n - 3] | (a[1 : n - 2] << 8) | (a[2 : n - 1] << 16)
            | (a[3:] << 24))


def find_matches(data: np.ndarray):
    """Per-position candidate matches via fingerprint sort.

    Returns (pos, dist, ml): positions with a verified match of length
    ml >= MIN_MATCH at distance dist, sorted by position. Candidate = the
    nearest previous position with the same 4-byte fingerprint.
    """
    n = len(data)
    if n < MIN_MATCH * 2:
        return (np.zeros(0, np.int64),) * 3
    fp = _fingerprints(data)
    m = len(fp)
    # stable sort by fingerprint keeps positions ascending within groups,
    # so each element's predecessor IS its nearest earlier occurrence
    order = np.argsort(fp, kind="stable")
    sfp = fp[order]
    same = np.zeros(m, bool)
    same[1:] = sfp[1:] == sfp[:-1]
    cand_of = order[np.flatnonzero(same)]          # candidate positions i
    cand_at = order[np.flatnonzero(same) - 1]      # their previous match j
    keep = (cand_of - cand_at) <= MAX_OFFSET
    pos = cand_of[keep]
    ref = cand_at[keep]
    if not len(pos):
        return (np.zeros(0, np.int64),) * 3

    # verified by construction for the first 4 bytes (equal fingerprints);
    # extend in vectorized 8-byte rounds over the shrinking survivor set
    ml = np.full(len(pos), MIN_MATCH, np.int64)
    alive = np.arange(len(pos))
    rounds = 0
    while len(alive) and rounds < 4096:  # ml cap 32 KiB (ratio-neutral)
        rounds += 1
        p = pos[alive] + ml[alive]
        r = ref[alive] + ml[alive]
        eq = np.ones(len(alive), bool)  # matched every byte so far this round
        adv = np.zeros(len(alive), np.int64)
        for k in range(8):
            idx = eq & (p + k < n)
            cur = np.zeros(len(alive), bool)
            cur[idx] = data[p[idx] + k] == data[r[idx] + k]
            hit = idx & cur
            adv += hit
            eq = hit
        ml[alive] += adv
        alive = alive[eq]
    o = np.argsort(pos, kind="stable")
    return pos[o], (pos - ref)[o], ml[o]


def greedy_parse(data: np.ndarray, min_gain: int = 4, reps=(1, 4, 8)):
    """Greedy left-to-right parse over the candidate matches.

    A match is taken only if ml >= MIN_MATCH (and a short lazy check: if the
    next position has a much longer match, emit one literal instead —
    level-2-ish parsing without chains), then a repeat-offset match within
    REP_GAIN bytes of it is preferred (match_device.rep_best — the cheap
    offset channel). Returns (seqs, literals) in the encode_sequences
    contract, or None when matching isn't worthwhile.
    """
    from .match_device import REP_GAIN, REP_MIN, rep_best, rep_update

    n = len(data)
    pos, dist, ml = find_matches(data)
    if not len(pos):
        return None
    seqs = []
    lit_parts = []
    cursor = 0
    i = 0
    np_pos = pos
    total_matched = 0
    reps = list(reps)
    while True:
        i = np.searchsorted(np_pos, cursor, side="left")
        if i >= len(np_pos):
            break
        p = int(np_pos[i])
        l = int(ml[i])
        d = int(dist[i])
        # lazy-ish: prefer the next candidate when it starts 1 byte later
        # and is materially longer (zstd's lazy heuristic, depth 1)
        if i + 1 < len(np_pos) and int(np_pos[i + 1]) == p + 1 \
                and int(ml[i + 1]) > l + 3:
            p1, l1, d1 = int(np_pos[i + 1]), int(ml[i + 1]), int(dist[i + 1])
            p, l, d = p1, l1, d1
        rr, rl = rep_best(data, p, reps, n, 32772)
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
