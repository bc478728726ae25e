"""RFC 8878 zstd frame assembly with Huffman-compressed literals.

Host/numpy reference implementation of the device entropy stage's format
layer (huff_device.py produces the same bitstreams for the bulk path). Blocks carry Huffman-coded literals AND full LZ77 sequences
(encode_block below: match finding + greedy parse + FSE-coded
LL/OF/ML streams), so output is plain standard zstd, decodable by libzstd
and by the C++ reference's decompressor (zstd_wrapper.h).
"""

import numpy as np

from .fse import BitWriter, fse_compress
from .huffman import build_ctable, code_lengths, weights_of

BLOCK_MAX = 128 * 1024
HUF_WEIGHT_TABLELOG = 6


def huffman_tree_description(lengths: np.ndarray) -> bytes | None:
    """Serialized Huffman tree (RFC 8878 §4.2.1.1): FSE-compressed weights,
    falling back to direct 4-bit weights for small alphabets."""
    weights, _ = weights_of(lengths)
    used = np.nonzero(weights)[0]
    last = int(used[-1])
    transmitted = weights[:last]  # last used symbol's weight is implicit
    comp = fse_compress(transmitted, 11, HUF_WEIGHT_TABLELOG) \
        if len(transmitted) else None
    if comp is not None and len(comp) < 128 and len(comp) < (
            len(transmitted) + 1) // 2 + 1:
        return bytes([len(comp)]) + comp
    if last <= 127:
        out = bytearray([127 + len(transmitted)])
        for i in range(0, len(transmitted), 2):
            hi = int(transmitted[i])
            lo = int(transmitted[i + 1]) if i + 1 < len(transmitted) else 0
            out.append((hi << 4) | lo)
        return bytes(out)
    if comp is not None and len(comp) < 128:
        return bytes([len(comp)]) + comp
    return None


def huf_encode_stream(data: np.ndarray, codes, lens) -> bytes:
    """One Huffman bitstream: symbols emitted in reverse order, stream read
    backward by the decoder."""
    bw = BitWriter()
    for s in data[::-1]:
        bw.add(int(codes[s]), int(lens[s]))
    return bw.close()


def compress_literals(data: np.ndarray):
    """-> (literals_section bytes, ok). data: uint8 array (<= BLOCK_MAX)."""
    n = len(data)
    if n < 64:
        return None
    counts = np.bincount(data, minlength=256)
    lens = code_lengths(counts)
    if int((lens > 0).sum()) < 2:
        return None  # RLE/raw territory
    codes, lens = build_ctable(lens)
    tree = huffman_tree_description(lens)
    if tree is None:
        return None
    s1 = (n + 3) // 4
    streams = [data[:s1], data[s1:2 * s1], data[2 * s1:3 * s1],
               data[3 * s1:]]
    encoded = [huf_encode_stream(s, codes, lens) for s in streams]
    if any(len(e) > 0xFFFF for e in encoded[:3]):
        return None
    jump = b"".join(len(e).to_bytes(2, "little") for e in encoded[:3])
    payload = tree + jump + b"".join(encoded)
    csize = len(payload)
    if csize >= n:
        return None
    # literals section header: type=2 (Compressed), size_format=3
    # (4 streams, 18-bit sizes, 5-byte header)
    hdr = 2 | (3 << 2) | (n << 4) | (csize << 22)
    return hdr.to_bytes(5, "little") + payload


def raw_literals_section(data: np.ndarray) -> bytes:
    """Raw_Literals_Block, size_format=3 (20-bit size, 3-byte header)."""
    hdr = 0 | (3 << 2) | (len(data) << 4)
    return hdr.to_bytes(3, "little") + data.tobytes()


def encode_block(data: np.ndarray, last: bool, reps=None, cand=None,
                 _force_py: bool = False):
    """One zstd block. reps: running repeat-offset registers (they persist
    across blocks within a frame, RFC 8878); None = frame start.
    cand: optional device match-candidate array (match_device) replacing
    the host fp4-map finder. Returns (block_bytes, reps_out).

    The native twin (stn_encode_block) runs when available — byte-identical
    output, ~100x the python loop; _force_py pins the python reference
    (tests compare the two)."""
    from .match import greedy_parse
    from .sequences import (FRESH_REPS, _recode_repeat_offsets,
                            encode_sequences, find_run_sequences)

    if reps is None:
        reps = FRESH_REPS
    if not _force_py:
        from ..native import lib as native

        if native is not None and hasattr(native, "encode_block"):
            rarr = np.asarray(reps, np.int64).copy()
            blk = native.encode_block(data, last, rarr, cand)
            return blk, tuple(int(v) for v in rarr)
    n = len(data)
    if n and (data == data[0]).all():
        bh = int(last) | (1 << 1) | (n << 3)
        return bh.to_bytes(3, "little") + bytes([int(data[0])]), reps

    candidates = []
    lit = compress_literals(data)
    if lit is not None:
        # literals-only, 0 sequences: registers unchanged
        candidates.append((lit + b"\x00", reps))

    if cand is not None:
        from .match_device import _parse_py

        match_finder = lambda d: _parse_py(d, cand, reps=reps)  # noqa: E731
    else:
        match_finder = lambda d: greedy_parse(d, reps=reps)  # noqa: E731
    for finder in (find_run_sequences, match_finder):
        rs = finder(data)
        if rs is None:
            continue
        seqs, lits = rs
        lsec = compress_literals(lits)
        if lsec is None:
            lsec = raw_literals_section(lits)
        _, reps_out = _recode_repeat_offsets(seqs, reps)
        candidates.append(
            (lsec + encode_sequences(seqs, reps=reps), reps_out))

    content, reps_out = min(candidates, key=lambda c: len(c[0])) \
        if candidates else (None, reps)
    if content is None or len(content) >= n:
        bh = int(last) | (0 << 1) | (n << 3)
        return bh.to_bytes(3, "little") + data.tobytes(), reps
    bh = int(last) | (2 << 1) | (len(content) << 3)
    return bh.to_bytes(3, "little") + content, reps_out


def _seq_anchors_on() -> bool:
    import os

    return os.environ.get("STENOS_SEQ_ANCHORS", "1") not in ("0", "false")


def _block_anchor_entry(blk: bytes):
    """Decode-anchor sidecar entry for a just-encoded single block (3-byte
    header + content): (lens (256,), anchors (4, 256)) when the block's
    literals are 4-stream Huffman — i.e. decodable by the anchored device
    kernel — else None. Works for SEQUENCE-BEARING blocks too: anchors are
    computed post-hoc (one native literal decode at encode time, then a
    numpy suffix-cumsum of code lengths), so the block encoders (python +
    native twin) and the frame bytes stay untouched; only the skippable
    sidecar grows. anchors[s][g] = bit read position of stream s's symbol
    g*128, counting from the stream bottom (huff_device semantics)."""
    from ..native import lib
    from .zstd_parse import BlockSpec, _parse_sections

    if lib is None:
        return None
    bh = int.from_bytes(blk[:3], "little")
    if ((bh >> 1) & 3) != 2:
        return None
    spec = BlockSpec(2, 3, len(blk) - 3, 0)
    if _parse_sections(blk, spec) is None:
        return None
    lit = spec.lit
    if (lit is None or lit.kind != "huf" or not lit.four or lit.treeless
            or lit.regenerated < 64):
        return None
    sec = blk[lit.off : lit.off + lit.length]
    if hasattr(lib, "huf_anchors"):
        # length-only native scan: no literal materialization at all
        # (tests pin it equal to the decode-then-cumsum reference below)
        r = lib.huf_anchors(sec, lit.regenerated, lib.zstd_ctx())
        if isinstance(r, int):
            return None
        return r[0].astype(np.int64), r[1]
    lits = lib.huf_lits(sec, True, False, lit.regenerated, lib.zstd_ctx())
    if isinstance(lits, int):
        return None
    lits = np.asarray(lits)
    if hasattr(lib, "huf_tree_lens"):
        # the exact lengths the section carries — no host table rebuild
        # (the heapq Huffman build was ~30% of the per-block encode cost)
        r = lib.huf_tree_lens(sec)
        if isinstance(r, int):
            return None
        lens = r[0].astype(np.int64)
    else:
        lens = code_lengths(np.bincount(lits, minlength=256))
        _, lens = build_ctable(lens)
    n = lit.regenerated
    s1 = (n + 3) // 4
    bounds = (0, s1, 2 * s1, 3 * s1, n)
    lens_sym = lens[lits].astype(np.int64)
    anchors = np.zeros((4, 256), np.int32)
    for s in range(4):
        seg = lens_sym[bounds[s] : bounds[s + 1]]
        suf = np.concatenate(
            [np.cumsum(seg[::-1])[::-1], np.zeros(1, np.int64)])
        gs = np.arange(0, len(seg), 128)
        anchors[s, : len(gs)] = suf[gs]
        # segments past the stream's last symbol re-decode from the last
        # real anchor (their output is sliced off); a repeat keeps every
        # sidecar u16 delta in range, unlike a drop to 0
        anchors[s, len(gs) :] = suf[gs[-1]] if len(gs) else 0
    return lens, anchors


def tree_descs_batch(lens_all):
    """Serialized tree descriptions for (n, 256) lengths: native C++ when
    available, python reference otherwise."""
    from ..native import lib as native

    if native is not None and hasattr(native, "huff_tree_descs"):
        return native.huff_tree_descs(lens_all)
    return [huffman_tree_description(lens_all[b])
            for b in range(lens_all.shape[0])]


def _huffman_block_sections(data, counts):
    """Shared host metadata for one full block: (codes, lens, tree) or None
    when the block should fall back (degenerate table / tree too big)."""
    lens = code_lengths(counts)
    if int((lens > 0).sum()) < 2:
        return None
    codes, lens = build_ctable(lens)
    tree = huffman_tree_description(lens)
    if tree is None:
        return None
    return codes, lens, tree


def encode_frame_device(data, sidecar: bool = True) -> bytes:
    """Same frames as encode_frame_host, but full 128 KiB blocks run their
    histogram + all four Huffman bitstreams on the device; the host only
    builds tables/tree descriptions and assembles sections. The partial
    tail block uses the host path.

    sidecar=True appends the decode-anchor skippable frame
    (entropy/sidecar.py) so the payload decompresses on device too; host
    decoders (libzstd, the C++ reference) skip it."""
    import os

    import jax.numpy as jnp

    from ..native import lib as native
    from .huff_device import encode_streams_device, histogram_device

    data = np.frombuffer(bytes(data), np.uint8) if not isinstance(
        data, np.ndarray) else np.asarray(data, np.uint8)
    n = len(data)
    out = bytearray()
    out += (0xFD2FB528).to_bytes(4, "little")
    out += bytes([0xA0])
    out += n.to_bytes(4, "little")
    if n == 0:
        out += (1 | (0 << 1) | (0 << 3)).to_bytes(3, "little")
        return bytes(out)
    nfull = n // BLOCK_MAX
    blocks = []
    sc_entries = []
    reps = None  # repeat-offset registers persist across blocks
    if nfull:
        full = data[: nfull * BLOCK_MAX].reshape(nfull, BLOCK_MAX)
        from .huffman import build_ctables_batch, code_lengths_batch

        # blocks with significant neighbor-equality runs route to the host
        # encoder, which can emit a sequences section (sequences.py); the
        # device kernel covers the (typical) literals-only bulk
        eqc = (full[:, 1:] == full[:, :-1]).sum(axis=1)
        runny = eqc >= BLOCK_MAX // 32
        # blocks with LZ potential (neighbor-equal runs OR duplicate
        # 4-grams) route to the sequence encoder. The match-finding
        # prepass is the native 16 KiB prefix sample and the native
        # fp4-map walk inside encode_block; STENOS_DEVICE_MATCH=1 runs the
        # device sort-based candidate finder instead (match_device.py).
        cands = {}
        if os.environ.get("STENOS_DEVICE_MATCH") == "1":
            from .match_device import match_candidates, matchiness

            CHUNK = 16
            mfrac = np.zeros(nfull, np.float32)
            for off in range(0, nfull, CHUNK):
                sel = np.arange(off, min(off + CHUNK, nfull))
                nb = 1
                while nb < len(sel):
                    nb <<= 1
                pad = np.zeros((nb, BLOCK_MAX), np.uint8)
                pad[: len(sel)] = full[sel]
                mfrac[sel] = matchiness(pad)[: len(sel)]
            runny = runny | (mfrac >= 1 / 8)
            runny_idx = np.flatnonzero(runny)
            for off in range(0, len(runny_idx), CHUNK):
                sel = runny_idx[off : off + CHUNK]
                nb = 1
                while nb < len(sel):
                    nb <<= 1
                pad = np.zeros((nb, BLOCK_MAX), np.uint8)
                pad[: len(sel)] = full[sel]
                got = match_candidates(pad)
                for j, b in enumerate(sel):
                    cands[int(b)] = got[j]
        else:
            mfrac = np.array(
                [native.matchiness(full[b]) for b in range(nfull)],
                np.float32)
            runny = runny | (mfrac >= 1 / 8)
        # the device histogram + Huffman-stream kernels run ONLY on the
        # non-runny subset, padded to a power of two (bounded compile
        # count): an all-runny frame (e.g. the records family on the
        # sequences path) dispatches NOTHING to the device — with a
        # poisoned bus its H2D cost alone would dominate the encode
        dev_idx = np.flatnonzero(~runny)
        metas = [None] * nfull
        sizes = anchors = wbytes = None
        if len(dev_idx):
            nbk = 1
            while nbk < len(dev_idx):
                nbk <<= 1
            padb = np.zeros((nbk, BLOCK_MAX), np.uint8)
            padb[: len(dev_idx)] = full[dev_idx]
            hist = np.asarray(histogram_device(jnp.asarray(padb)))
            lens_all = code_lengths_batch(hist)
            codes_all = build_ctables_batch(lens_all)
            trees = tree_descs_batch(lens_all)
            luts = np.zeros((nbk, 256), np.int32)
            for j, b in enumerate(dev_idx):
                if int((lens_all[j] > 0).sum()) < 2 or trees[j] is None:
                    continue
                metas[b] = (j, lens_all[j], trees[j])
                luts[j] = (codes_all[j].astype(np.int32)
                           | (lens_all[j].astype(np.int32) << 11))
            streams = padb.reshape(nbk * 4, BLOCK_MAX // 4)
            slut = np.repeat(luts, 4, axis=0)
            words, sizes, anchors = encode_streams_device(
                jnp.asarray(streams), jnp.asarray(slut))
            words = np.ascontiguousarray(np.asarray(words))
            sizes = np.asarray(sizes)
            anchors = np.asarray(anchors)
            wbytes = words.view("<u1").reshape(nbk * 4, -1)
        for b in range(nfull):
            chunk = full[b]
            last = (b == nfull - 1) and n == nfull * BLOCK_MAX
            m = metas[b]
            if m is None:
                blk, reps = encode_block(chunk, last, reps,
                                         cand=cands.get(b))
                blocks.append(blk)
                sc_entries.append(_block_anchor_entry(blk)
                                  if sidecar and _seq_anchors_on() else None)
                continue
            j, lens_b, tree = m
            enc = [bytes(wbytes[4 * j + s][: sizes[4 * j + s]])
                   for s in range(4)]
            if any(len(e) > 0xFFFF for e in enc[:3]):
                blk, reps = encode_block(chunk, last, reps)
                blocks.append(blk)
                sc_entries.append(_block_anchor_entry(blk)
                                  if sidecar and _seq_anchors_on() else None)
                continue
            jump = b"".join(len(e).to_bytes(2, "little") for e in enc[:3])
            payload = tree + jump + b"".join(enc)
            csize = len(payload)
            if csize + 6 >= BLOCK_MAX:
                blk, reps = encode_block(chunk, last, reps)
                blocks.append(blk)
                sc_entries.append(_block_anchor_entry(blk)
                                  if sidecar and _seq_anchors_on() else None)
                continue
            hdr = 2 | (3 << 2) | (BLOCK_MAX << 4) | (csize << 22)
            content = hdr.to_bytes(5, "little") + payload + b"\x00"
            bh = int(last) | (2 << 1) | (len(content) << 3)
            blocks.append(bh.to_bytes(3, "little") + content)
            sc_entries.append((lens_b, anchors[4 * j : 4 * j + 4]))
    if n > nfull * BLOCK_MAX:
        blk, reps = encode_block(data[nfull * BLOCK_MAX :], True, reps)
        blocks.append(blk)
        sc_entries.append(_block_anchor_entry(blk)
                          if sidecar and _seq_anchors_on() else None)
    for blk in blocks:
        out += blk
    if sidecar and any(e is not None for e in sc_entries):
        from .sidecar import pack_sidecar

        out += pack_sidecar(sc_entries)
    return bytes(out)


def encode_frame_host(data) -> bytes:
    """data: bytes / uint8 array -> a standard zstd frame (single segment,
    4-byte content size, literals-only blocks)."""
    data = np.frombuffer(bytes(data), np.uint8) if not isinstance(
        data, np.ndarray) else np.asarray(data, np.uint8)
    n = len(data)
    out = bytearray()
    out += (0xFD2FB528).to_bytes(4, "little")
    out += bytes([0xA0])  # FCS 4 bytes, single segment
    out += n.to_bytes(4, "little")
    if n == 0:
        out += (1 | (0 << 1) | (0 << 3)).to_bytes(3, "little")
        return bytes(out)
    pos = 0
    reps = None
    while pos < n:
        chunk = data[pos : pos + BLOCK_MAX]
        pos += len(chunk)
        blk, reps = encode_block(chunk, pos >= n, reps)
        out += blk
    return bytes(out)
