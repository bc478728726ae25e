"""Huffman table construction for zstd literals (RFC 8878 §4.2.1).

Host-side metadata work (256-symbol histogram -> length-limited code), the
analog of libzstd's HUF_buildCTable: the table is a few hundred
bytes of per-superblock metadata; the bulk encode runs on device.

zstd specifics honored here:
  - max code length 11 (literals), table completeness sum(2^(w-1)) = 2^maxBits
  - weight w = maxBits + 1 - length, 0 for unused symbols
  - canonical code assignment must match the decoder's reconstruction from
    weights: codes are dealt from value 0 upward starting at the LONGEST
    length (lowest weight), symbols in increasing order within a weight.
"""

import heapq

import numpy as np

MAX_BITS = 11


def code_lengths(counts: np.ndarray, max_bits: int = MAX_BITS):
    """counts (256,) -> lengths (256,) (0 = unused), length-limited.

    Plain Huffman first; if too deep, depth-limit then repair the Kraft sum
    (the standard heuristic: deepen the shallowest overweight leaves)."""
    counts = np.asarray(counts, np.int64)
    used = np.nonzero(counts)[0]
    lengths = np.zeros(256, np.int32)
    if len(used) == 0:
        return lengths
    if len(used) == 1:
        lengths[used[0]] = 1
        return lengths
    heap = [(int(counts[s]), int(s), 0, None, None) for s in used]
    heapq.heapify(heap)
    uid = 256
    while len(heap) > 1:
        a = heapq.heappop(heap)
        b = heapq.heappop(heap)
        heapq.heappush(heap, (a[0] + b[0], uid, 1 + max(a[2], b[2]), a, b))
        uid += 1
    stack = [(heap[0], 0)]
    while stack:
        node, depth = stack.pop()
        if node[3] is None:
            lengths[node[1]] = max(depth, 1)
        else:
            stack.append((node[3], depth + 1))
            stack.append((node[4], depth + 1))
    if lengths.max() > max_bits:
        # clamp and repair Kraft sum K = sum 2^-len up to 1
        lengths = np.minimum(lengths, max_bits)
        unit = 1 << max_bits  # work in units of 2^-max_bits
        k = int(np.sum((lengths > 0) * (1 << (max_bits - lengths))))
        # overflow: lengthen cheap (most frequent have short codes; lengthen
        # the least frequent short-coded symbols first)
        order = np.argsort(counts, kind="stable")  # ascending frequency
        while k > unit:
            for s in order:
                if lengths[s] and lengths[s] < max_bits:
                    k -= (1 << (max_bits - lengths[s])) >> 1
                    lengths[s] += 1
                    if k <= unit:
                        break
        # underflow: shorten the most frequent symbols where possible
        changed = True
        while k < unit and changed:
            changed = False
            for s in order[::-1]:
                if lengths[s] > 1:
                    gain = 1 << (max_bits - lengths[s])
                    if k + gain <= unit:
                        lengths[s] -= 1
                        k += gain
                        changed = True
                        if k == unit:
                            break
        assert k == unit, (k, unit)
    return lengths


def build_ctable(lengths: np.ndarray):
    """lengths (256,) -> (codes (256,) uint32, lengths) canonical per zstd.

    Decoder semantics (RFC 8878 §4.2.1.1): symbols are ranked by weight
    ascending (= length descending), ties by symbol value ascending; codes
    are assigned sequentially from 0 in that order, where moving to a
    shorter length right-shifts the running code value."""
    lengths = np.asarray(lengths, np.int32)
    codes = np.zeros(256, np.uint32)
    maxlen = int(lengths.max())
    if maxlen == 0:
        return codes, lengths
    code = 0
    prev_len = maxlen
    for ln in range(maxlen, 0, -1):
        code >>= (prev_len - ln)
        prev_len = ln
        for s in range(256):
            if lengths[s] == ln:
                codes[s] = code
                code += 1
    return codes, lengths


def code_lengths_batch(counts: np.ndarray, max_bits: int = MAX_BITS):
    """counts (n, 256) -> lengths (n, 256) via the native C++ builder when
    available (the python heap is ~0.7 ms/block; C++ is ~10 us)."""
    from ..native import lib as native

    counts = np.ascontiguousarray(counts, np.int64)
    n = counts.shape[0]
    if native is not None and hasattr(native, "huff_lengths"):
        return native.huff_lengths(counts, max_bits)
    return np.stack([code_lengths(counts[i], max_bits) for i in range(n)])


def build_ctables_batch(lengths: np.ndarray):
    """Vectorized canonical code assignment (same convention as
    build_ctable) for (n, 256) lengths -> (n, 256) codes."""
    lengths = np.asarray(lengths, np.int32)
    n = lengths.shape[0]
    maxlen = MAX_BITS
    # per-length symbol counts and bases: base_maxlen = 0;
    # base_l = (base_{l'} + n_{l'}) >> (l' - l) for the next longer l'
    nl = np.stack([(lengths == ln).sum(axis=1)
                   for ln in range(maxlen + 1)], axis=1)  # (n, maxlen+1)
    base = np.zeros((n, maxlen + 1), np.int64)
    code = np.zeros(n, np.int64)
    prev = maxlen
    for ln in range(maxlen, 0, -1):
        code >>= (prev - ln)
        prev = ln
        base[:, ln] = code
        code = code + nl[:, ln]
    # rank within the same length, symbols ascending
    codes = np.zeros((n, 256), np.int64)
    for ln in range(1, maxlen + 1):
        m = lengths == ln
        rank = np.cumsum(m, axis=1) - m
        codes = np.where(m, base[:, ln : ln + 1] + rank, codes)
    return codes.astype(np.uint32)


def weights_of(lengths: np.ndarray):
    """weight = maxBits + 1 - length (0 for unused)."""
    lengths = np.asarray(lengths, np.int32)
    maxlen = int(lengths.max())
    w = np.where(lengths > 0, maxlen + 1 - lengths, 0)
    return w.astype(np.int32), maxlen
