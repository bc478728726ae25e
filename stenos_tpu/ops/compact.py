"""Order-preserving ragged compaction / expansion as pure vector ops.

The core primitive of the device block codec. The stenos format is a ragged
concatenation of variable-size sections; CPUs emit it with pointer-walking
writes and parse it with pointer-walking reads. Here both directions are
expressed as monotone shifts executed in log4(width) masked-roll stages —
roll + compare + select only, no data-dependent gathers or scatters (a
gather formulation is the open alternative on the GPU).

Correctness of the ascending-bit schedule (compaction): remaining shifts are
multiples of 2^k before stage k and order-preserving targets are strictly
increasing; two valid elements colliding at stage k would need shift
difference < 2^k while both shifts are multiples of 2^k with different bit k
— a contradiction. Expansion (right shifts) is the mirror image.

Layout convention: `valid` lanes, read left-to-right, are the stream.
Compaction moves lane i left by (i - #valid_before_i); expansion moves
stream byte s right to its destination lane.
"""


RADIX_BITS = 2  # radix-4 stages: half the passes of radix-2


def _stages(width: int) -> int:
    s = 0
    while (1 << s) < width:
        s += 1
    return s


def _digit_stages(width: int):
    """(shift_bits, digit) pairs for radix-2**RADIX_BITS moves, low digit
    first. The collision-freedom proof generalizes: before stage k remaining
    shifts are multiples of R^k; a collision would need two same-stage
    movers whose shift difference is a positive multiple of R^k smaller
    than the digit delta times R^k — impossible mod R^(k+1)."""
    out = []
    k = 0
    while (1 << k) < width:
        out.append(k)
        k += RADIX_BITS
    return out


def compact(xp, values, valid, width: int | None = None):
    """Compact valid lanes of (..., W) to the front (order preserved).

    Returns (compacted_values, counts): lanes beyond counts are zero.
    Packed-word implementation: value (8b) | shift (<<8) in one int32 lane.
    """
    W = values.shape[-1]
    v = values.astype(xp.int32) & 255
    val = valid.astype(xp.int32)
    # shift[i] = i - exclusive_count_of_valid(i), 0 for invalid lanes
    inc = xp.cumsum(val, axis=-1)
    pos = xp.arange(W, dtype=xp.int32)
    shift = xp.where(val.astype(bool), pos - (inc - 1), 0)
    w = xp.where(val.astype(bool), v | (shift << 8) | (1 << 30), 0)
    lanes = xp.arange(W, dtype=xp.int32)
    mask_d = (1 << RADIX_BITS) - 1
    for k in _digit_stages(width or W):
        base = 1 << k
        new = xp.where((w != 0) & ((((w >> 8) >> k) & mask_d) == 0), w, 0)
        for d in range(1, 1 << RADIX_BITS):
            step = d * base
            moved = xp.roll(w, -step, axis=-1)
            moved = xp.where(lanes >= W - step, 0, moved)
            arrive = (((moved >> 8) >> k) & mask_d) == d
            new = xp.where(arrive & (moved != 0),
                           moved - (step << 8), new)
        w = new
    return w & 255, inc[..., -1]


def expand(xp, stream, starts, window: int):
    """Inverse: slice (..., n_seg) segments starting at `starts` (monotone,
    within the (..., L) stream) into (..., n_seg, window) padded windows.

    Bytes past a segment (into the next) are NOT materialized — lanes whose
    source would belong to a later segment come out as zeros; callers mask by
    size. Each stream byte lands in exactly one window.

    PRECONDITION: every segment's size must be <= window (callers size the
    window to the format's max section size); otherwise shift monotonicity —
    and hence the collision-freedom proof — breaks and windows are garbage
    (memory-safe, but wrong). Valid stenos streams always satisfy this.
    """
    L = stream.shape[-1]
    n_seg = starts.shape[-1]
    W = window
    # owner segment of each stream byte: scatter-free via compare+sum over
    # segments is O(L*n_seg); instead use the diff-mark + cumsum trick.
    marks = xp.zeros(stream.shape[:-1] + (L + 1,), xp.int32)
    ones = xp.ones(starts.shape, xp.int32)
    marks = _scatter_add(xp, marks, starts, ones)
    owner = xp.cumsum(marks[..., :L], axis=-1) - 1  # -1 before first segment
    # destination lane of byte s: owner*W + (s - start[owner])
    start_of = _take(xp, starts, xp.clip(owner, 0, n_seg - 1))
    inwin = xp.arange(L, dtype=xp.int32) - start_of
    dest_ok = (owner >= 0) & (inwin < W)
    # windows live at [L, L + n_seg*W) so every move is rightward
    target = L + owner * W + inwin
    pos = xp.arange(L, dtype=xp.int32)
    shift = xp.where(dest_ok, target - pos, 0)  # >= 0, monotone
    out_w = L + n_seg * W
    v = stream.astype(xp.int32) & 255
    w = xp.where(dest_ok, v | (shift << 8) | (1 << 30), 0)
    pad = xp.zeros(stream.shape[:-1] + (out_w - L,), xp.int32)
    w = xp.concatenate([w, pad], axis=-1)
    w = shift_right_packed(xp, w, out_w)
    out = (w & 255)[..., L:]
    return out.reshape(out.shape[:-1] + (n_seg, W))


def shift_right_packed(xp, w, out_w: int):
    """Move packed lanes (value | shift<<8, nonzero=occupied) RIGHT by their
    shifts; descending digit order (the mirror of compaction's ascending
    schedule — right-moves with non-decreasing shifts collide otherwise)."""
    lanes = xp.arange(out_w, dtype=xp.int32)
    mask_d = (1 << RADIX_BITS) - 1
    for k in reversed(_digit_stages(out_w)):
        base = 1 << k
        new = xp.where((w != 0) & ((((w >> 8) >> k) & mask_d) == 0), w, 0)
        for d in range(1, 1 << RADIX_BITS):
            step = d * base
            moved = xp.roll(w, step, axis=-1)
            moved = xp.where(lanes < step, 0, moved)
            arrive = (((moved >> 8) >> k) & mask_d) == d
            new = xp.where(arrive & (moved != 0),
                           moved - (step << 8), new)
        w = new
    return w


def fill_left(xp, values, have, width: int = 16):
    """Propagate the nearest value to the LEFT into empty lanes (RLE repeat
    reconstruction): out[i] = values[j] for the largest j<=i with have[j];
    lanes before the first filled lane stay 0 and keep have=False."""
    v = values.astype(xp.int32)
    h = have.astype(bool)
    k = 1
    while k < width:
        pv = xp.roll(v, k, axis=-1)
        ph = xp.roll(h, k, axis=-1)
        head = xp.arange(values.shape[-1], dtype=xp.int32) < k
        ph = xp.where(head, False, ph)
        # only adopt the rolled value when its source lane was filled —
        # otherwise wrap-around garbage leaks into the leading empty lanes
        v = xp.where(h, v, xp.where(ph, pv, v))
        h = h | ph
        k <<= 1
    return v, h


def _scatter_add(xp, arr, idx, vals):
    """arr (..., M) += vals at idx (..., n) along the last axis."""
    import numpy as _np

    flatA = arr.reshape(-1, arr.shape[-1])
    flatI = idx.reshape(-1, idx.shape[-1])
    flatV = vals.reshape(-1, vals.shape[-1])
    rows = xp.arange(flatA.shape[0], dtype=xp.int32)[:, None]
    if xp is _np:
        out = flatA.copy()
        _np.add.at(out, (rows + 0 * flatI, flatI), flatV)
        return out.reshape(arr.shape)
    out = flatA.at[rows, flatI].add(flatV)
    return out.reshape(arr.shape)


def _take(xp, table, idx):
    """table (..., M), idx (..., n) -> values along the last axis."""
    flatT = table.reshape(-1, table.shape[-1])
    flatI = idx.reshape(-1, idx.shape[-1])
    rows = xp.arange(flatT.shape[0], dtype=xp.int32)[:, None]
    if hasattr(flatT, "at") or True:
        out = flatT[rows + 0 * flatI, flatI]
    return out.reshape(idx.shape)
