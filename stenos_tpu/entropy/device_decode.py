"""Device-side decompression of zstd entropy payloads.

Covers the entropy half of methods ZSTD / TRANSPOSED_ZSTD /
TRANSPOSED_DELTA_ZSTD (and method-5 residuals). Two tiers:

1. Literals-only sidecar frames (the common output of
   encode_frame_device): all-device — the host walks only the
   frame/block/section headers (O(metadata)) and the Huffman bitstreams
   decode on the device (huff_device).
2. Sequence-bearing and foreign (libzstd-produced) frames: the host does
   the O(nseq) index work — native FSE sequence decode (stn_zstd_seqs)
   compiled into a W-chunked copy-op program (stn_seq_ops); the device
   executes the bulk match reconstruction (seq_exec.run_programs) and the
   result stays in HBM for the follow-on unshuffle / delta_inv. Literal
   bytes of ANY block with sidecar anchors — sequence-bearing included
   (zstd_frame._block_anchor_entry) — decode on the device too and are
   patched into the staged buffer on-device; only anchor-less blocks'
   literals (foreign frames) decode on the host.

Payloads neither tier understands return None and the caller falls back
to host libzstd — the graceful-degradation ladder of stenos.cpp:681-753.
"""

import numpy as np

import jax

from .sidecar import split_sidecar
from .zstd_parse import parse_frame

BLOCK_MAX = 131072
W = 1024  # op chunk: bytes copied per sequence op


def _parse_device_block(payload: bytes, start: int, bsize: int):
    """Our device block layout: 5-byte literals header (type 2, sf 3),
    tree desc, 6-byte jump table, 4 streams, 1 zero sequences byte.
    Returns (regenerated, [4 stream byte spans]) or None."""
    end = start + bsize
    h = int.from_bytes(payload[start : start + 5], "little")
    if (h & 3) != 2 or ((h >> 2) & 3) != 3:
        return None
    regenerated = (h >> 4) & 0x3FFFF
    csize = (h >> 22) & 0x3FFFF
    p = start + 5
    tb = payload[p]
    if tb < 128:
        tree_len = 1 + tb
    else:
        tree_len = 1 + ((tb - 127) + 1) // 2
    lit_end = p + csize
    p += tree_len
    if p + 6 > lit_end or lit_end > end:
        return None
    j1 = int.from_bytes(payload[p : p + 2], "little")
    j2 = int.from_bytes(payload[p + 2 : p + 4], "little")
    j3 = int.from_bytes(payload[p + 4 : p + 6], "little")
    p += 6
    s4 = lit_end - (p + j1 + j2 + j3)
    if s4 <= 0:
        return None
    spans = [(p, j1), (p + j1, j2), (p + j1 + j2, j3),
             (p + j1 + j2 + j3, s4)]
    if payload[lit_end:end] != b"\x00":  # zero sequences only
        return None
    return regenerated, spans


def _lit_spans(payload, lit):
    """4-stream byte spans of a 'huf' literals section (tree desc skipped).
    Returns [(off, len)] * 4 or None."""
    p = lit.off
    lit_end = lit.off + lit.length
    tb = payload[p]
    if tb < 128:
        tree_len = 1 + tb
    else:
        tree_len = 1 + ((tb - 127) + 1) // 2
    p += tree_len
    if p + 6 > lit_end:
        return None
    j1 = int.from_bytes(payload[p : p + 2], "little")
    j2 = int.from_bytes(payload[p + 2 : p + 4], "little")
    j3 = int.from_bytes(payload[p + 4 : p + 6], "little")
    p += 6
    s4 = lit_end - (p + j1 + j2 + j3)
    if s4 <= 0:
        return None
    return [(p, j1), (p + j1, j2), (p + j1 + j2, j3),
            (p + j1 + j2 + j3, s4)]


def _batch_decode_streams(payload, jobs):
    """Batch the anchored 4-stream Huffman decode. jobs: list of
    (spans, (lens, anchors)) — one per block, 4 streams each. Returns a
    (4 * len(jobs), 32768) uint8 device array of decoded symbols (each
    stream's valid prefix is its own symbol count; the rest is garbage
    segments driven by zero anchors)."""
    import jax.numpy as jnp

    from .huff_device import decode_streams_device, decode_tables

    ns = len(jobs) * 4
    eb = max(max(ln for spans, _ in jobs for (_, ln) in spans), 1)
    eb = -(-(eb) // 128) * 128
    sb = np.zeros((ns, eb), np.uint8)
    anch = np.zeros((ns, 256), np.int32)
    tabs = np.zeros((ns, 304), np.int32)
    pv = np.frombuffer(payload, np.uint8)
    for b, (spans, (lens, anchors)) in enumerate(jobs):
        tab = decode_tables(lens)
        for s, (off, ln) in enumerate(spans):
            sb[4 * b + s, :ln] = pv[off : off + ln]
            anch[4 * b + s] = anchors[s]
            tabs[4 * b + s] = tab[0]
    return decode_streams_device(jnp.asarray(sb), jnp.asarray(anch),
                                 jnp.asarray(tabs))


def _decode_all_device(payload, dsize, blocks, entries):
    """Tier 1: every block a full-size literals-only device block."""
    nfull = 0
    jobs = []
    for spec, ent in zip(blocks, entries):
        if ent is None or spec.btype != 2:
            return None
        pb = _parse_device_block(payload, spec.start, spec.size)
        if pb is None or pb[0] != BLOCK_MAX:
            return None
        jobs.append((pb[1], ent))
        nfull += 1
    if nfull * BLOCK_MAX != dsize:
        return None
    return _batch_decode_streams(payload, jobs).reshape(dsize)


@jax.jit
def _scatter_rows(buf, flat, dst, src):
    return buf.at[dst].set(flat[src], mode="drop", unique_indices=True)


def _patch_from_rows(buf, rows, pspecs):
    """Assemble each patch's literal bytes from its 4 decoded stream rows
    and write them into buf — one gather + scatter on device, driven by
    host-built index arrays padded to a power of two (so a few compiled
    shapes serve every frame).

    pspecs: iterable of (row_base, n, off): streams rows[row_base:row_base+4]
    carry ceil(n/4)/…/n-3*ceil(n/4) valid symbols (the compress_literals
    split); the concatenation lands at buf[off : off+n]."""
    width = rows.shape[1]
    dst, src = [], []
    for rb, n, off in pspecs:
        s1 = (n + 3) // 4
        for k, ln in enumerate((s1, s1, s1, n - 3 * s1)):
            dst.append(np.arange(off, off + ln, dtype=np.int32))
            src.append(np.arange(ln, dtype=np.int32) + (rb + k) * width)
            off += ln
    dst = np.concatenate(dst)
    size = 1 << max(int(len(dst)) - 1, 1).bit_length()
    pad = size - len(dst)
    # padding writes land past the buffer and are dropped
    dst = np.concatenate([dst, np.full(pad, buf.shape[0], np.int32)])
    src = np.concatenate(src + [np.zeros(pad, np.int32)])
    return _scatter_rows(buf, rows.reshape(-1), dst, src)


def _decode_sequences_device(payload, dsize, blocks, entries=None):
    """Tier 2: host index work, device match reconstruction; in MIXED
    frames (literals-only device blocks interleaved with sequence-bearing
    ones) the anchored blocks' Huffman streams still decode on the device —
    their rows are patched into the staged buffer on-device — and only the
    anchor-less blocks' literals decode on the host.
    Returns a device (dsize,) uint8 array or None.

    Buffer layout (parallel lanes): the out area is (nb, BLOCK_MAX + W)
    rows — one block per row, the W row-tail absorbing each lane's
    final-op overrun so concurrently-executing lanes never clobber a
    neighbor; extraction is a static reshape/slice. That layout requires
    every block to sit at content offset b * BLOCK_MAX (true for zstd
    writers, which fill blocks) and no cross-block matches (true for our
    encoder, entropy/match.py MAX_OFFSET). Anything else — foreign
    frames with history reaching across blocks, short mid-frame blocks —
    runs as ONE sequential lane over a gapless layout, where ordered
    overwrite makes the tails harmless."""
    import jax.numpy as jnp

    from ..native import lib
    from . import seq_exec

    pv = np.frombuffer(payload, np.uint8)
    row = BLOCK_MAX + W

    # ---- host pass: literals + O(nseq) index work per block ----
    ctx = lib.zstd_ctx()
    reps = np.array([1, 4, 8], np.int64)
    # specs: ("direct", content_off, piece, None)
    #      | ("seq", content_off, lits, (ll, ml, off, trailing))
    # patches: (spec_index, job_index, n) — that spec's piece is a zeros
    # placeholder; the real literal bytes come from the batched device
    # stream decode and are written into the staged buffer ON-DEVICE
    specs = []
    jobs = []
    patches = []
    out_off = 0
    if entries is not None and len(entries) != len(blocks):
        entries = None
    for bi, spec in enumerate(blocks):
        ent = entries[bi] if entries is not None else None
        if spec.btype == 0:
            piece = np.array(pv[spec.start : spec.start + spec.size])
        elif spec.btype == 1:
            piece = np.full(spec.rsize, payload[spec.start], np.uint8)
        else:
            piece = None
        if piece is not None:
            if len(piece) > BLOCK_MAX:
                return None
            specs.append(("direct", out_off, piece, None))
            out_off += len(piece)
            continue
        lit = spec.lit
        if lit.regenerated > BLOCK_MAX:
            return None
        dev_job = None
        if (ent is None and lit.kind == "huf" and lit.four
                and not lit.treeless and lit.regenerated >= 64
                and hasattr(lib, "huf_anchors")):
            # FOREIGN block (no sidecar): the host scans the streams once
            # for code LENGTHS only — no symbol materialization — and the
            # bytes decode on the device through the same anchored decoder
            # (stn_huf_anchors; reference decodes all payloads uniformly,
            # stenos.cpp:694-753)
            r = lib.huf_anchors(
                payload[lit.off : lit.off + lit.length], lit.regenerated,
                ctx)
            if not isinstance(r, int):
                ent = r
        if (ent is not None and lit.kind == "huf" and lit.four
                and not lit.treeless and lit.regenerated >= 64):
            spans = _lit_spans(payload, lit)
            if spans is not None:
                jobs.append((spans, ent))
                dev_job = len(jobs) - 1
        if dev_job is not None:
            lits = np.zeros(lit.regenerated, np.uint8)  # device-patched
        elif lit.kind == "raw":
            lits = np.array(pv[lit.off : lit.off + lit.length])
        elif lit.kind == "rle":
            lits = np.full(lit.regenerated, lit.byte, np.uint8)
        else:
            lits = lib.huf_lits(
                payload[lit.off : lit.off + lit.length], lit.four,
                lit.treeless, lit.regenerated, ctx)
            if isinstance(lits, int):
                return None
        if spec.seq_len == 1 and payload[spec.seq_off] == 0:
            specs.append(("direct", out_off, np.asarray(lits), None))
            if dev_job is not None:
                patches.append((len(specs) - 1, dev_job, lit.regenerated))
            out_off += lit.regenerated
            continue
        sec = payload[spec.seq_off : spec.seq_off + spec.seq_len]
        r = lib.zstd_seqs(sec, reps, ctx)
        if isinstance(r, int):
            return None
        ll, ml, off = r
        body = int(ll.sum() + ml.sum())
        trailing = lit.regenerated - int(ll.sum())
        if trailing < 0 or body + trailing > BLOCK_MAX:
            return None
        specs.append(("seq", out_off, np.asarray(lits),
                      (ll, ml, off, trailing)))
        if dev_job is not None:
            patches.append((len(specs) - 1, dev_job, lit.regenerated))
        out_off += body + trailing
    if out_off != dsize:
        return None

    patched = {si for si, _, _ in patches}
    if not any(k == "seq" for k, _, _, _ in specs):
        # no sequence work at all: ship the direct pieces as the result,
        # patching device-decoded literal rows in on-device
        stage = np.zeros(max(dsize, 1), np.uint8)
        for i, (k, off_, piece, _) in enumerate(specs):
            if i not in patched:
                stage[off_ : off_ + len(piece)] = piece
        buf = jnp.asarray(stage[:dsize])
        if patches:
            rows = _batch_decode_streams(payload, jobs)
            buf = _patch_from_rows(
                buf, rows,
                tuple((4 * jk, n, specs[si][1]) for si, jk, n in patches))
        return buf

    # the literal area sits BEFORE the out area: out-area ops overrun
    # their dst by up to W-1 bytes (ordered overwrite), and a trailing
    # spill must land in scratch, never on literals a later op still reads
    def build(gapped):
        """Compile specs into lane programs + placements for one layout.
        Returns (progs, placements, lit_total, buf_len) or None when a
        copy-op reaches before its block (cross-block match) under gapped.

        gapped: one lane per block at row strides (parallel execution,
        direct pieces pre-placed in their own rows). gapless: ONE ordered
        lane over a dense layout; direct pieces ride copy-ops too, so a
        preceding block's W-overrun is repaired before later matches
        read them."""
        lit_total = sum(len(piece) for k, _, piece, _ in specs
                        if k == "seq" or not gapped)
        progs, placed = [], []
        cur = 0
        for b, (kind, off_, piece, seq) in enumerate(specs):
            boff = lit_total + (b * row if gapped else off_)
            if kind == "direct":
                if gapped:
                    placed.append((boff, piece))
                else:
                    placed.append((cur, piece))
                    cs = np.arange(0, max(len(piece), 1), W, np.int32)
                    progs.append(np.stack([boff + cs, cur + cs], 1))
                    cur += len(piece)
                continue
            ll, ml, off, trailing = seq
            placed.append((cur, piece))
            body = int(ll.sum() + ml.sum())
            ops = lib.seq_ops(ll, ml, off, boff, cur,
                              trailing, boff + body + trailing, W)
            if isinstance(ops, int):
                return None
            matches = ops[ops[:, 2] == 0, 1]
            if gapped and np.any(matches < boff):
                return None  # cross-block match: parallel lanes invalid
            if not gapped and np.any(matches < lit_total):
                return None  # corrupt: offset reaches before the frame
            progs.append(ops[:, :2])
            cur += len(piece)
        out_len = len(specs) * row if gapped else dsize
        return progs, placed, lit_total, lit_total + out_len

    aligned = all(off_ == b * BLOCK_MAX
                  for b, (_, off_, _, _) in enumerate(specs))
    built = build(True) if aligned else None
    gapped = built is not None
    if not gapped:
        built = build(False)
        if built is None:
            return None
        progs, placed, lit_total, buf_len = built
        progs = [np.concatenate(progs, 0)]  # one ordered lane
    else:
        progs, placed, lit_total, buf_len = built

    dst, src, total = seq_exec.pack_programs(progs, buf_len, W)
    stage = np.zeros(total, np.uint8)
    for i, (off_, piece) in enumerate(placed):
        if i not in patched:
            stage[off_ : off_ + len(piece)] = piece
    buf = jnp.asarray(stage)
    if patches:
        # anchored literal streams decode on the device and land in the
        # staged buffer there (the copy-op programs then read them like
        # any host-placed piece)
        rows = _batch_decode_streams(payload, jobs)
        buf = _patch_from_rows(
            buf, rows,
            tuple((4 * jk, n, placed[si][0]) for si, jk, n in patches))
    buf = seq_exec.run_programs(buf, jnp.asarray(dst), jnp.asarray(src), W)
    if gapped:
        rows = buf[lit_total : lit_total + len(specs) * row]
        rows = rows.reshape(len(specs), row)
        return rows[:, :BLOCK_MAX].reshape(-1)[:dsize]
    return buf[lit_total : lit_total + dsize]


def decode_payload_device(payload, dsize: int):
    """payload: method-2/3/4/5 superblock payload (zstd frame [+ sidecar]).
    Returns a device (dsize,) uint8 array, or None when the payload isn't
    device-decodable (caller falls back to host libzstd)."""
    payload = bytes(payload)
    frame_end, entries = split_sidecar(payload)
    parsed = parse_frame(payload, frame_end)
    if parsed is None:
        return None
    content, blocks, _ = parsed
    if content is not None and content != dsize:
        return None
    if entries is not None and len(blocks) == len(entries):
        out = _decode_all_device(payload, dsize, blocks, entries)
        if out is not None:
            return out
    return _decode_sequences_device(payload, dsize, blocks, entries)
