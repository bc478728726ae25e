"""General zstd frame/block structural parser (host, O(headers)).

Splits any zstd frame — ours or libzstd-produced — into per-block literal
and sequence section descriptors, without touching the bulk payload bytes.
The bulk work is delegated:
  - literals: device anchored Huffman kernel (sidecar present) or native
    host decode (stn_huf_lits)
  - sequences: native O(nseq) FSE decode (stn_zstd_seqs) + W-chunked
    copy-op program (stn_seq_ops), executed on device (seq_exec.py)

Reference behavior matched: stenos.cpp:694-753 routes every method
2/3/4/5 payload through full zstd decompression (zstd_wrapper.h:59-90);
here the same payloads decode with the bulk bytes staying on the device.
Format: RFC 8878 §3.1.1.
"""

from __future__ import annotations

import dataclasses

import numpy as np

MAGIC = 0xFD2FB528
SKIPPABLE_LO = 0x184D2A50


@dataclasses.dataclass
class LitSpec:
    kind: str          # "raw" | "rle" | "huf"
    regenerated: int
    off: int = 0       # raw/huf: byte offset into payload
    length: int = 0    # raw/huf: section byte length
    byte: int = 0      # rle fill byte
    four: bool = False     # huf: 4-stream layout
    treeless: bool = False  # huf: reuse previous block's table


@dataclasses.dataclass
class BlockSpec:
    btype: int          # 0 raw, 1 RLE, 2 compressed
    start: int          # payload offset of the block body
    size: int           # block body bytes (RLE: 1)
    rsize: int          # regenerated bytes (raw/RLE blocks)
    lit: LitSpec | None = None     # compressed blocks only
    seq_off: int = 0    # sequences section offset (compressed)
    seq_len: int = 0


def parse_frame(payload, end: int | None = None):
    """Walk one zstd frame's headers -> (content_size or None, [BlockSpec],
    frame_end). Returns None if the structure is not a lone zstd frame we
    understand (caller falls back to host libzstd)."""
    payload = memoryview(payload)
    n = len(payload) if end is None else end
    if n < 5 or int.from_bytes(payload[:4], "little") != MAGIC:
        return None
    fhd = payload[4]
    p = 5
    dict_flag = fhd & 3
    checksum = (fhd >> 2) & 1
    single = (fhd >> 5) & 1
    fcs_code = fhd >> 6
    if dict_flag:
        return None  # dictionaries unsupported (the reference never uses them)
    if not single:
        p += 1  # window descriptor
    fcs_bytes = {0: 1 if single else 0, 1: 2, 2: 4, 3: 8}[fcs_code]
    content = None
    if fcs_bytes:
        if p + fcs_bytes > n:
            return None
        content = int.from_bytes(payload[p : p + fcs_bytes], "little")
        if fcs_bytes == 2:
            content += 256
        p += fcs_bytes
    blocks = []
    last = False
    while not last:
        if p + 3 > n:
            return None
        bh = int.from_bytes(payload[p : p + 3], "little")
        last = bool(bh & 1)
        btype = (bh >> 1) & 3
        bsize = bh >> 3
        p += 3
        if btype == 3:
            return None
        body = 1 if btype == 1 else bsize
        if p + body > n:
            return None
        rsize = bsize if btype != 2 else 0
        spec = BlockSpec(btype, p, body, rsize)
        if btype == 2:
            if _parse_sections(payload, spec) is None:
                return None
        blocks.append(spec)
        p += body
    if checksum:
        p += 4
    if p > n:
        return None
    return content, blocks, p


def _parse_sections(payload, spec: BlockSpec):
    """Fill lit/seq fields of a compressed block (RFC §3.1.1.3.1)."""
    p = spec.start
    end = spec.start + spec.size
    if p >= end:
        return None
    b0 = payload[p]
    ltype = b0 & 3
    sf = (b0 >> 2) & 3
    if ltype <= 1:  # Raw / RLE
        if sf == 0 or sf == 2:
            regen = b0 >> 3
            hlen = 1
        elif sf == 1:
            if p + 2 > end:
                return None
            regen = (b0 >> 4) | (payload[p + 1] << 4)
            hlen = 2
        else:
            if p + 3 > end:
                return None
            regen = (b0 >> 4) | (payload[p + 1] << 4) | (payload[p + 2] << 12)
            hlen = 3
        body = regen if ltype == 0 else 1
        if p + hlen + body > end:
            return None
        if ltype == 0:
            spec.lit = LitSpec("raw", regen, off=p + hlen, length=regen)
        else:
            spec.lit = LitSpec("rle", regen, byte=payload[p + hlen])
        p += hlen + body
    else:  # Compressed / Treeless
        if sf == 0 or sf == 1:
            if p + 3 > end:
                return None
            h = int.from_bytes(payload[p : p + 3], "little")
            regen = (h >> 4) & 0x3FF
            csize = (h >> 14) & 0x3FF
            hlen = 3
            four = sf == 1
        elif sf == 2:
            if p + 4 > end:
                return None
            h = int.from_bytes(payload[p : p + 4], "little")
            regen = (h >> 4) & 0x3FFF
            csize = (h >> 18) & 0x3FFF
            hlen = 4
            four = True
        else:
            if p + 5 > end:
                return None
            h = int.from_bytes(payload[p : p + 5], "little")
            regen = (h >> 4) & 0x3FFFF
            csize = (h >> 22) & 0x3FFFF
            hlen = 5
            four = True
        if p + hlen + csize > end:
            return None
        spec.lit = LitSpec("huf", regen, off=p + hlen, length=csize,
                           four=four, treeless=ltype == 3)
        p += hlen + csize
    spec.seq_off = p
    spec.seq_len = end - p
    return spec


def decode_frame_native(payload, end: int | None = None):
    """Full host decode of one zstd frame through the native primitives
    (stn_huf_lits / stn_zstd_seqs + python match reconstruction). Used to
    validate the native zstd machinery against libzstd and as the
    O(1-core) fallback when libzstd is unavailable. Returns bytes or None."""
    from ..native import lib

    if lib is None:
        return None
    parsed = parse_frame(payload, end)
    if parsed is None:
        return None
    content, blocks, _ = parsed
    payload = bytes(payload)
    pv = np.frombuffer(payload, np.uint8)
    ctx = lib.zstd_ctx()
    reps = np.array([1, 4, 8], np.int64)
    out = bytearray()
    for spec in blocks:
        if spec.btype == 0:
            out += payload[spec.start : spec.start + spec.size]
            continue
        if spec.btype == 1:
            out += payload[spec.start : spec.start + 1] * spec.rsize
            continue
        lit = spec.lit
        if lit.kind == "raw":
            lits = pv[lit.off : lit.off + lit.length]
        elif lit.kind == "rle":
            lits = np.full(lit.regenerated, lit.byte, np.uint8)
        else:
            lits = lib.huf_lits(payload[lit.off : lit.off + lit.length],
                                lit.four, lit.treeless, lit.regenerated, ctx)
            if isinstance(lits, int):
                return None
        if spec.seq_len == 1 and payload[spec.seq_off] == 0:
            out += lits.tobytes()
            continue
        sec = payload[spec.seq_off : spec.seq_off + spec.seq_len]
        r = lib.zstd_seqs(sec, reps, ctx)
        if isinstance(r, int):
            return None
        ll, ml, off = r
        lits = np.asarray(lits)
        lp = 0
        for i in range(len(ll)):
            out += lits[lp : lp + ll[i]].tobytes()
            lp += int(ll[i])
            o, m = int(off[i]), int(ml[i])
            if o > len(out):
                return None
            for _ in range(m):  # byte-wise: handles overlap
                out.append(out[-o])
        out += lits[lp:].tobytes()
    if content is not None and len(out) != content:
        return None
    return bytes(out)
