"""zstd sequences section (RFC 8878 §3.1.1.3.2). Clean-room from the RFC.

Two match sources feed this encoder: vectorized offset-1 run matches
(find_run_sequences below) and the general-offset sort-based matcher
(entropy/match.py). Each of the three symbol channels (LL/OF/ML)
independently picks Predefined_Mode (RFC fixed distributions, no header),
RLE_Mode (single symbol, 1-byte header) or FSE_Compressed_Mode (custom
normalized table serialized as an NCount header — the
FSE_writeNCount-equivalent lives in fse.write_ncount) by exact cost,
mirroring the three-way choice libzstd makes inside the reference's
entropy stage (zstd_wrapper.h:59-90)."""

import numpy as np

from .fse import BitWriter, FseEncoder

# --- code tables (RFC 8878 §3.1.1.3.2.1.1) --------------------------------

# literal length code: (baseline, nb_extra_bits) for codes 16..35; 0..15 map
# directly with 0 extra bits
LL_TABLE = [(16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3),
            (40, 3), (48, 4), (64, 6), (128, 7), (256, 8), (512, 9),
            (1024, 10), (2048, 11), (4096, 12), (8192, 13), (16384, 14),
            (32768, 15), (65536, 16)]

# match length code: (baseline in MATCH LENGTH, nb_extra) for codes 32..52;
# codes 0..31 map ml 3..34 with 0 extra bits
ML_TABLE = [(35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3),
            (59, 3), (67, 4), (83, 4), (99, 5), (131, 7), (259, 8),
            (515, 9), (1027, 10), (2051, 11), (4099, 12), (8195, 13),
            (16387, 14), (32771, 15), (65539, 16)]

# predefined FSE distributions (RFC 8878 §3.1.1.3.2.2)
LL_DEFAULT = [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1,
              2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1]
LL_LOG = 6
ML_DEFAULT = [1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
              1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
              1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1,
              -1, -1, -1]
ML_LOG = 6
OF_DEFAULT = [1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
              1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1]
OF_LOG = 5


def ll_code(ll: int):
    """literal length -> (code, extra_bits). Extra bit VALUE is the low
    bits of the raw length (baselines are aligned)."""
    if ll < 16:
        return ll, 0
    for i, (base, nb) in enumerate(LL_TABLE):
        if ll < base + (1 << nb):
            return 16 + i, nb
    raise ValueError(ll)


def ml_code(ml: int):
    """match length (>= 3) -> (code, extra_bits)."""
    if ml < 35:
        return ml - 3, 0
    for i, (base, nb) in enumerate(ML_TABLE):
        if ml < base + (1 << nb):
            return 32 + i, nb
    raise ValueError(ml)


def of_code(offset_value: int):
    """offset_value -> (code = highbit, extra = low bits, nb = code)."""
    c = offset_value.bit_length() - 1
    return c, offset_value - (1 << c), c


class _RleEncoder:
    """Mode-1 channel: table log 0 — zero bits per symbol, zero-bit states."""

    def init_state(self, sym):
        pass

    def encode(self, bw, sym):
        pass

    def flush(self, bw):
        pass


def _channel_plan(codes, default_norm, default_log, max_log):
    """Pick Predefined / RLE / FSE_Compressed for one symbol channel.

    codes: list of (code, nb_extra) pairs for the channel.
    Returns (mode, header_bytes, encoder_factory). Cost model: exact header
    size + Shannon bits of the code stream under each table
    (zstd_wrapper.h's libzstd makes the same three-way choice internally).
    """
    return _channel_plan_syms(np.asarray([c for c, _ in codes], np.int64),
                              default_norm, default_log, max_log)


def _channel_plan_syms(syms, default_norm, default_log, max_log):
    """_channel_plan on a plain symbol-code array (no per-sequence python
    pairs)."""
    from .fse import normalize_counts, write_ncount

    syms = np.asarray(syms, np.int64)
    n = len(syms)
    counts = np.bincount(syms)
    present = np.flatnonzero(counts)
    if len(present) == 1:
        return 1, bytes([int(present[0])]), lambda: _RleEncoder()

    dn = np.asarray(default_norm, np.int64)
    max_sym = int(syms.max())
    cost_pre = None
    if max_sym < len(dn):
        p = np.maximum(dn, 1) / (1 << default_log)
        cost_pre = float(np.sum(counts * -np.log2(p[: len(counts)])))

    tl = max(5, int(np.ceil(np.log2(len(present)))),
             (n - 1).bit_length() - 2)
    tl = min(max_log, tl)
    while (1 << tl) < len(present):
        tl += 1
    norm = normalize_counts(counts, tl, n)
    header = write_ncount(norm, tl, max_sym)
    pc = norm / (1 << tl)
    nz = counts > 0
    cost_cust = len(header) * 8 + float(
        np.sum(counts[nz] * -np.log2(pc[nz])))

    if cost_pre is not None and cost_pre <= cost_cust:
        return 0, b"", lambda: FseEncoder(dn, default_log)
    return 2, header, lambda: FseEncoder(norm, tl)


FRESH_REPS = (1, 4, 8)  # frame-start recent-offset registers (RFC 8878)


def _recode_repeat_offsets(seqs, reps=FRESH_REPS):
    """Rewrite raw offset_values (offset + 3) as repeat-offset codes 1-3
    where the zstd recent-offset registers allow it (RFC 8878
    §3.1.1.3.2.1.1; update rules mirror libzstd's ZSTD_updateRep). Turns
    constant-offset streams (runs at offset 1) into an RLE offset channel.

    The registers PERSIST ACROSS BLOCKS within a frame: callers encoding a
    multi-block frame must pass the running registers and adopt the
    returned ones. Returns (recoded_seqs, reps_out)."""
    reps = list(reps)
    out = []
    for ll, ofv, ml in seqs:
        off = ofv - 3
        if ll != 0:
            if off == reps[0]:
                code = 1
            elif off == reps[1]:
                code = 2
            elif off == reps[2]:
                code = 3
            else:
                code = 0
        else:
            if off == reps[1]:
                code = 1
            elif off == reps[2]:
                code = 2
            elif off == reps[0] - 1:
                code = 3
            else:
                code = 0
        if code == 0:
            out.append((ll, off + 3, ml))
            reps = [off, reps[0], reps[1]]
        else:
            out.append((ll, code, ml))
            rep_idx = code - 1 + (1 if ll == 0 else 0)
            if rep_idx == 1:
                reps = [reps[1], reps[0], reps[2]]
            elif rep_idx == 2:
                reps = [reps[2], reps[0], reps[1]]
            elif rep_idx == 3:
                reps = [reps[0] - 1, reps[0], reps[1]]
    return out, reps


def encode_sequences(seqs, mode: str = "auto",
                     reps=FRESH_REPS) -> bytes:
    """seqs: list of (literal_length, offset_value, match_length) ->
    sequences section bytes. Input offset_value = offset + 3; repeat
    offsets (codes 1-3) are substituted internally where the recent-offset
    registers match (constant-offset runs become an RLE offset channel).

    mode 'auto' picks Predefined / RLE / FSE_Compressed (custom NCount
    tables) independently per channel; 'predefined' forces mode 0 on all
    three (the round-sequences fast path)."""
    n = len(seqs)
    out = bytearray()
    if n < 128:
        out.append(n)
    elif n < 0x7F00:
        # byte0 in [128, 254]: n = ((byte0 - 128) << 8) + byte1 (RFC 8878);
        # 255 is reserved as the three-byte-form prefix, so n >= 0x7F00
        # must use the long form even though (n >> 8) + 128 still fits a byte
        out.append((n >> 8) + 128)
        out.append(n & 255)
    else:
        out += bytes([255, (n - 0x7F00) & 255, (n - 0x7F00) >> 8])
    if n == 0:
        return bytes(out)

    seqs, _ = _recode_repeat_offsets(seqs, reps)
    lls = [s[0] for s in seqs]
    ofs = [s[1] for s in seqs]
    mls = [s[2] for s in seqs]
    llc = [ll_code(v) for v in lls]
    mlc = [ml_code(v) for v in mls]
    ofc = [of_code(v) for v in ofs]

    if mode == "predefined":
        out.append(0)
        e_ll = FseEncoder(np.asarray(LL_DEFAULT), LL_LOG)
        e_of = FseEncoder(np.asarray(OF_DEFAULT), OF_LOG)
        e_ml = FseEncoder(np.asarray(ML_DEFAULT), ML_LOG)
    else:
        ll_m, ll_h, ll_f = _channel_plan(llc, LL_DEFAULT, LL_LOG, 9)
        of_m, of_h, of_f = _channel_plan(
            [(c, nb) for c, _, nb in ofc], OF_DEFAULT, OF_LOG, 8)
        ml_m, ml_h, ml_f = _channel_plan(mlc, ML_DEFAULT, ML_LOG, 9)
        out.append((ll_m << 6) | (of_m << 4) | (ml_m << 2))
        # FSE table descriptions follow in LL, OF, ML order (RFC 8878)
        out += ll_h + of_h + ml_h
        e_ll, e_of, e_ml = ll_f(), of_f(), ml_f()
    bw = BitWriter()
    last = n - 1
    e_ml.init_state(mlc[last][0])
    e_of.init_state(ofc[last][0])
    e_ll.init_state(llc[last][0])
    # extra-bit values: raw ll (LL baselines are aligned), ml-3 (baselines
    # align in mlBase = ml - MINMATCH space), offset_value low bits
    bw.add(lls[last], llc[last][1])
    bw.add(mls[last] - 3, mlc[last][1])
    bw.add(ofc[last][1], ofc[last][2])
    for i in range(n - 2, -1, -1):
        e_of.encode(bw, ofc[i][0])
        e_ml.encode(bw, mlc[i][0])
        e_ll.encode(bw, llc[i][0])
        bw.add(lls[i], llc[i][1])
        bw.add(mls[i] - 3, mlc[i][1])
        bw.add(ofc[i][1], ofc[i][2])
    e_ml.flush(bw)
    e_of.flush(bw)
    e_ll.flush(bw)
    return bytes(out) + bw.close()


def find_run_sequences(data: np.ndarray, min_run: int = 8):
    """Offset-1 run matches, found vectorized: neighbor-equality runs of
    total length >= min_run become (ll, offset_value=4, ml) sequences.

    Returns (sequences, literals) or None when not worthwhile. A zstd match
    needs ml >= 3; the threshold trades sequence overhead (~2-3 B) for
    saved literals."""
    n = len(data)
    if n < 16:
        return None
    eq = data[1:] == data[:-1]
    # run boundaries over the eq mask
    d = np.diff(eq.astype(np.int8))
    starts = np.flatnonzero(d == 1) + 1
    ends = np.flatnonzero(d == -1) + 1
    if eq[0]:
        starts = np.concatenate([[0], starts])
    if eq[-1]:
        ends = np.concatenate([ends, [n - 1]])
    # run of k equal-neighbor flags = k+1 equal bytes at [s, s+k+1)
    lens = ends - starts + 1  # equal BYTES count per run
    keep = lens >= min_run
    if not keep.any():
        return None
    starts = starts[keep]
    lens = lens[keep]
    if int(lens.sum()) < max(64, n // 64):
        return None  # not enough matched bytes to pay for the section
    seqs = []
    lits = []
    cursor = 0
    for s, ln in zip(starts, lens):
        # keep the first byte as a literal, match the rest at offset 1
        ll = s + 1 - cursor
        ml = int(ln) - 1
        if ml < 3:
            continue
        lits.append(data[cursor : s + 1])
        seqs.append((int(ll), 4, ml))  # offset_value 4 == offset 1
        cursor = s + int(ln)
    if not seqs:
        return None
    lits.append(data[cursor:])
    return seqs, np.concatenate(lits) if lits else np.zeros(0, np.uint8)
