"""Device-resident compressed array.

Where container.CompressedArray keeps compressed chunks in HOST memory (the
drop-in cvector equivalent), this container keeps them in device memory:
data lives as compressed frame records plus the decode index the encoder
emits (engine_jax.encode_records_body with_index), and slabs decompress on
demand with the derive-index decoder — no host byte traffic in either
direction. This is the cvector analog for device-scale working sets
(checkpoint shards, cold activations, archived KV blocks):
memory_footprint is the compressed device bytes, access is slab-granular.

Interop: serialize() emits a standard stenos frame (custom-blocksize header,
stenos.h:159-168) decodable by the C++ reference; deserialize() adopts a
frame via the batched host parser. Mirrors cvector's serialize contract
(cvector.hpp:3034-3193) at slab granularity.

Cost model: the random-access index is ONE int32 per 256-byte plane
(offset | plane-code<<24) = 1.6% of the uncompressed size; the decoder
derives the row records from the stream's own header bytes, so no row
table is stored.
"""

import numpy as np

import jax
import jax.numpy as jnp


class DeviceCompressedArray:
    """Immutable-shape device-resident compressed array of a fixed dtype.

    Build with from_array / deserialize; read via slab(i), __getitem__
    (element/slice, decodes the covering slabs), or to_array().
    """

    def __init__(self, dtype, slab_bytes: int, nbytes: int, rows, totals,
                 plane_off, tail: bytes):
        self.dtype = np.dtype(dtype)
        self.slab_bytes = slab_bytes
        self.nbytes = nbytes
        self._rows = rows            # (n_slabs, rb) uint8, device
        self._totals = totals        # (n_slabs,) int32, host numpy
        self._plane_off = plane_off  # (n_slabs, P) i32, off | code<<24
        self._tail = tail            # bytes beyond the last full slab
        # original compressed records (host bytes), kept when adopting an
        # external frame whose virtual stream differs from its record bytes
        # (LZ/COPY blocks inlined by the parser); serialize() prefers these
        self._records = None
        # optional packed device entropy stage (records huffman-coded in
        # device memory; _rows dropped when active)
        self._entropy = None

    # ---------------------------------------------------------- construct
    @classmethod
    def from_array(cls, arr, slab_elems: int | None = None,
                   block_level: int = 2, entropy: bool = False):
        """arr: 1-D numpy/jax array of a fixed-size dtype. slab_elems
        defaults to 128 KiB worth of elements (the reference superblock).

        entropy=True adds the device entropy stage on top of the block
        codec (the BLOCK_ZSTD analog for device-resident data): slab
        records pack into shared 128 KiB huffman blocks, and reads
        huffman-decode on device (anchored decoder) before the block
        decode — no host byte traffic in either direction. See
        _EntropyStore."""
        from .engine_jax import _bucket125, encode_records_jit, rounds

        a = np.asarray(arr)
        dtype = a.dtype
        bpp = dtype.itemsize
        # nb must be a power of two <= 128 so serialize()'s custom-shift
        # frame header (slab = block << shift) is exactly representable;
        # wide elements get smaller slabs (encode working set scales with
        # bpp*nb)
        cap = min(128, max(8, 1024 // bpp))
        nb = 1
        while nb * 2 <= cap:
            nb *= 2
        if slab_elems is not None:
            nb = 1
            while nb * 2 <= min(slab_elems // 256, cap):
                nb *= 2
        slab_elems = nb * 256
        slab_bytes = slab_elems * bpp
        raw = a.view(np.uint8).reshape(-1)
        nbytes = len(raw)
        n_slabs = nbytes // slab_bytes
        tail = raw[n_slabs * slab_bytes :].tobytes()
        if n_slabs == 0:
            return cls(dtype, slab_bytes, nbytes, None, np.zeros(0, np.int32),
                       None, tail)
        batch = raw[: n_slabs * slab_bytes].reshape(n_slabs, slab_bytes)
        parts = [encode_records_jit(jnp.asarray(batch[i : i + r]), bpp,
                                    block_level, with_index=True)
                 for i, r in rounds(n_slabs, slab_bytes)]
        totals = np.concatenate([np.asarray(p[1]) for p in parts])
        rb = min(_bucket125(int(totals.max()) + 512), parts[0][0].shape[1])
        # drop padding beyond the bucket
        rows = jnp.concatenate([p[0][:, :rb] for p in parts])
        po = jnp.concatenate([p[4] for p in parts])
        self = cls(dtype, slab_bytes, nbytes, rows, totals, po, tail)
        if entropy:
            self._entropy = _EntropyStore.pack(rows, totals, rb)
            if self._entropy is not None:
                self._rows = None  # records live entropy-coded now
        return self

    @classmethod
    def deserialize(cls, frame: bytes, dtype):
        """Adopt a standard stenos frame (any producer, incl. the C++
        reference) without decompressing: host parses the decode index, the
        payloads go to device memory. Frames with other methods are
        decompressed by frame.decompress and re-compressed."""
        from . import frame as fr
        from .engine_jax import _bucket125
        from .native import lib as native

        dtype = np.dtype(dtype)
        bpp = dtype.itemsize
        dsize, sb, pos = fr.get_info(frame, bpp)
        ok = sb % (256 * bpp) == 0
        offs, csizes = [], []
        p = pos
        n_full = dsize // sb
        if ok:
            for _ in range(n_full):
                if p + 4 > len(frame) or frame[p] != 1:
                    ok = False
                    break
                c = int.from_bytes(frame[p + 1 : p + 4], "little")
                offs.append(p + 4)
                csizes.append(c)
                p += 4 + c
        if not ok or n_full == 0:
            data = fr.decompress(frame, bpp)
            return cls.from_array(np.frombuffer(bytes(data), dtype))
        row_bytes = _bucket125(max(csizes) + 512)
        r = native.parse_rows_batch(frame, bpp, sb, offs, csizes, row_bytes)
        if isinstance(r, int):
            data = fr.decompress(frame, bpp)
            return cls.from_array(np.frombuffer(bytes(data), dtype))
        vbufs, plane_off, _rowtab, vlens = r
        row_bytes = vbufs.shape[1]  # may have grown on the LZ-retry path
        tail = b""
        if dsize > n_full * sb:  # short last superblock: decode on host
            tail = bytes(fr.decompress(frame, bpp)[n_full * sb :])
        # note: parsed offsets are payload-relative; the container's rows
        # are records (4-byte header included) — prepend headers.
        # rows hold the VIRTUAL stream (length vlens[i], >= csize when LZ
        # blocks were inlined); the original records are kept separately so
        # serialize() re-emits the adopted frame bytes verbatim.
        rows = np.zeros((n_full, row_bytes + 4), np.uint8)
        totals = np.zeros(n_full, np.int32)
        records = []
        for i in range(n_full):
            v = int(vlens[i])
            rows[i, :4] = np.frombuffer(
                frame[offs[i] - 4 : offs[i]], np.uint8)
            rows[i, 4 : 4 + v] = vbufs[i, :v]
            totals[i] = v + 4
            records.append(frame[offs[i] - 4 : offs[i] + csizes[i]])
        # rebase only the low 24 offset bits: bits 24+ carry the plane code
        po = (((plane_off & 0xFFFFFF) + 4) | (plane_off & ~0xFFFFFF)).astype(
            np.int32)
        self = cls(dtype, sb, dsize, jnp.asarray(rows), totals,
                   jnp.asarray(po), tail)
        self._records = records
        return self

    # ------------------------------------------------------------- access
    @property
    def n_slabs(self) -> int:
        if self._totals is not None and len(self._totals):
            return int(len(self._totals))
        return 0 if self._rows is None else self._rows.shape[0]

    def __len__(self) -> int:
        return self.nbytes // self.dtype.itemsize

    def slab(self, i: int):
        """Decode slab i -> (slab_bytes,) uint8 jax array, device-resident
        (bitcast to the element dtype on device as needed)."""
        return self._decode_range(i, i + 1).reshape(-1)

    def _decode_range(self, s0: int, s1: int):
        """Slabs [s0, s1) -> (s1 - s0, slab_bytes) uint8 on device."""
        from .engine_jax import decode_slabs_derive_jit

        nb = self.slab_bytes // (256 * self.dtype.itemsize)
        if self._entropy is not None:
            vbufs = self._entropy.slab_vbufs(s0, s1)
        else:
            vbufs = self._rows[s0:s1]
        return decode_slabs_derive_jit(
            vbufs, self._plane_off[s0:s1], self.dtype.itemsize, nb)

    def to_array(self) -> np.ndarray:
        out = np.empty(self.nbytes, np.uint8)
        sb = self.slab_bytes
        from .engine_jax import rounds

        for i, r in rounds(self.n_slabs, sb):
            out[i * sb : (i + r) * sb] = np.asarray(
                self._decode_range(i, i + r)).reshape(-1)
        if self._tail:
            out[self.nbytes - len(self._tail) :] = np.frombuffer(
                self._tail, np.uint8)
        return out.view(self.dtype)

    def __getitem__(self, idx):
        esize = self.dtype.itemsize
        n = len(self)
        if isinstance(idx, int):
            if idx < 0:
                idx += n
            b = idx * esize
            s = b // self.slab_bytes
            if s >= self.n_slabs:
                off = b - self.n_slabs * self.slab_bytes
                return np.frombuffer(self._tail, self.dtype,
                                     count=1, offset=off)[0]
            body = np.asarray(self._decode_range(s, s + 1))
            off = b - s * self.slab_bytes
            return np.frombuffer(body.reshape(-1)[off : off + esize].tobytes(),
                                 self.dtype)[0]
        if isinstance(idx, slice):
            start, stop, step = idx.indices(n)
            return self.to_array()[start:stop:step]
        raise TypeError(idx)

    # ------------------------------------------------------------ metrics
    def memory_footprint(self) -> int:
        """Compressed device bytes + index (the cvector memory_footprint
        analog, cvector.hpp:1886-1895)."""
        if self._entropy is not None:
            e = self._entropy
            return (int(e.words.shape[0]) * int(e.words.shape[1]) * 4
                    + e.anchors.size * 4 + e.tabs.size * 4
                    + len(e.raw) * e.BLOCK
                    + self._plane_off.size * 4 + len(self._tail))
        if self._rows is None:
            return len(self._tail)
        return (int(self._rows.shape[0]) * int(self._rows.shape[1])
                + self._plane_off.size * 4 + len(self._tail))

    def current_compression_ratio(self) -> float:
        return self.nbytes / max(self.memory_footprint(), 1)

    # ------------------------------------------------------ serialization
    def serialize(self) -> bytes:
        """Standard stenos frame (custom-blocksize header) — decodable by
        stenos_decompress and by frame.decompress."""
        from . import frame as fr

        out = bytearray()
        out += bytes([255]) + self.nbytes.to_bytes(7, "little")
        out += self.slab_bytes.to_bytes(4, "little")
        if self._records is not None:
            for rec in self._records:
                out += rec
        elif self.n_slabs:
            if self._entropy is not None:
                # reconstitute the method-BLOCK records from the entropy
                # store (serialized frames carry the block-codec stage;
                # the huffman stage is container-internal)
                e = self._entropy
                nblk = len(e.flags)
                flat = np.asarray(e.decode_blocks(0, nblk))
                for i in range(self.n_slabs):
                    o = int(e.offs[i])
                    out += bytes(flat[o : o + int(e.totals[i])])
            else:
                rows = np.asarray(self._rows)
                for i in range(self.n_slabs):
                    out += bytes(rows[i][: self._totals[i]])
        if self._tail:
            blob = fr.compress(np.frombuffer(self._tail, np.uint8),
                               self.dtype.itemsize, 1,
                               custom_shift=_shift_of(self.slab_bytes,
                                                      self.dtype.itemsize))
            out += blob[12:]  # strip its header, keep superblock records
        return bytes(out)


def _shift_of(slab_bytes: int, bpp: int) -> int:
    block = 256 * bpp
    shift = 0
    while (block << shift) < slab_bytes:
        shift += 1
    return shift


class _EntropyStore:
    """Packed device entropy stage for a DeviceCompressedArray.

    Slab records concatenate into shared 128 KiB huffman blocks (the
    BLOCK_ZSTD residual-entropy idea, stenos.cpp:582-603, restructured for
    fixed shapes): each block's four 32 KiB streams encode with the device
    huffman coder (anchors emitted for free), and reads decode the
    covering blocks with the anchored decoder — compressed bytes, anchors
    and tables all stay in device memory. Blocks whose table degenerates or
    that don't shrink stay raw (flag 0). Random access costs the 1-2
    entropy blocks covering the slab's span."""

    BLOCK = 131072

    def __init__(self, words, sizes, anchors, tabs, flags, raw, offs,
                 totals, rb):
        # words/sizes/anchors/tabs hold rows for CODED blocks only (4
        # streams per coded block, in block order); raw-flagged blocks live
        # exclusively in self.raw
        self.words = words        # (ncoded*4, wbucket/4) uint32, device
        self.sizes = sizes        # (ncoded*4,) host
        self.anchors = anchors    # (ncoded*4, 256) int32, device
        self.tabs = tabs          # (ncoded*4, 304) int32, device
        self.flags = flags        # (nblk,) host bool: 1 = huffman-coded
        self.raw = raw            # dict blk -> (BLOCK,) uint8 device
        self.offs = offs          # (n_slabs,) host record offsets
        self.totals = totals      # (n_slabs,) host record lengths
        self.rb = rb
        # block index -> row group in the packed arrays
        self._packed = {int(b): j for j, b in enumerate(np.flatnonzero(flags))}

    @classmethod
    def pack(cls, rows, totals, rb):
        from .engine_jax import _frame_assemble
        from .entropy.huff_device import (decode_tables,
                                          encode_streams_device,
                                          histogram_device)
        from .entropy.huffman import build_ctables_batch, code_lengths_batch

        totals = np.asarray(totals)
        offs = (np.cumsum(totals) - totals).astype(np.int32)
        total_len = int(totals.sum())
        nblk = -(-total_len // cls.BLOCK)
        if nblk == 0:
            return None
        cap = nblk * cls.BLOCK
        # slack past cap: dynamic_update_slice CLAMPS out-of-range starts,
        # so the buffer must fit the last record's full padded row
        concat = _frame_assemble(rows, jnp.asarray(offs),
                                 np.zeros(8, np.uint8),
                                 cap + rows.shape[1])[:cap]
        blocks = concat.reshape(nblk, cls.BLOCK)
        hist = np.asarray(histogram_device(blocks))
        lens_all = code_lengths_batch(hist)
        codes_all = build_ctables_batch(lens_all)
        luts = (codes_all.astype(np.int32)
                | (lens_all.astype(np.int32) << 11))
        streams = blocks.reshape(nblk * 4, cls.BLOCK // 4)
        words, sizes, anchors = encode_streams_device(
            streams, jnp.asarray(np.repeat(luts, 4, axis=0)))
        sizes = np.asarray(sizes)
        flags = np.ones(nblk, bool)
        raw = {}
        for b in range(nblk):
            ok = int((lens_all[b] > 0).sum()) >= 2
            # anchors+tables cost ~5.2 KiB/block: require a real gain
            if ok and sizes[4 * b : 4 * b + 4].sum() + 5200 \
                    < cls.BLOCK * 92 // 100:
                continue
            flags[b] = False
            raw[b] = blocks[b]
        if not flags.any():
            return None
        # keep only the coded blocks' rows on device: raw-flagged blocks are
        # served from self.raw, so their word/anchor/table rows would be
        # dead weight in the footprint and the profitability test
        coded = np.flatnonzero(flags)
        ridx = (coded[:, None] * 4 + np.arange(4)).reshape(-1)
        tabs = np.zeros((len(coded) * 4, 304), np.int32)
        for j, b in enumerate(coded):
            t = decode_tables(lens_all[b])
            tabs[4 * j : 4 * j + 4] = t[0]
        wbucket = -(-int(sizes[ridx].max()) // 512) * 512
        words = jnp.asarray(words[ridx, : wbucket // 4])
        store = cls(words, sizes[ridx], jnp.asarray(anchors)[ridx],
                    jnp.asarray(tabs), flags, raw, offs, totals, rb)
        # the whole stage must beat the plain record store, or it's off
        plain_bytes = int(rows.shape[0]) * int(rows.shape[1])
        ours = (int(words.shape[0]) * int(words.shape[1]) * 4
                + store.anchors.size * 4 + tabs.size * 4
                + len(raw) * cls.BLOCK)
        if ours >= plain_bytes:
            return None
        return store

    def decode_blocks(self, b0: int, b1: int):
        """-> ((b1-b0) * BLOCK,) uint8 device (+rb zero slack appended)."""
        from .entropy.huff_device import decode_streams_device

        coded = [b for b in range(b0, b1) if self.flags[b]]
        dec = None
        if coded:
            ridx = np.asarray([4 * self._packed[b] + k for b in coded
                               for k in range(4)])
            w = self.words[ridx]
            ns = w.shape[0]
            wbytes = jax.lax.bitcast_convert_type(w, jnp.uint8).reshape(
                ns, -1)
            syms = decode_streams_device(
                wbytes, self.anchors[ridx], self.tabs[ridx])
            dec = syms.reshape(len(coded), self.BLOCK)
        parts = []
        j = 0
        for b in range(b0, b1):
            if self.flags[b]:
                parts.append(dec[j])
                j += 1
            else:
                parts.append(self.raw[b])
        parts.append(jnp.zeros(self.rb, jnp.uint8))
        return jnp.concatenate([p.reshape(-1) for p in parts])

    def slab_vbufs(self, s0: int, s1: int):
        """Reassemble records for slabs [s0, s1) -> (s1-s0, rb) uint8."""
        lo = int(self.offs[s0])
        hi = int(self.offs[s1 - 1] + self.totals[s1 - 1])
        b0 = lo // self.BLOCK
        b1 = -(-hi // self.BLOCK)
        flat = self.decode_blocks(b0, b1)
        parts = [
            jax.lax.dynamic_slice(flat, (int(self.offs[i]) - b0 * self.BLOCK,),
                                  (self.rb,))
            for i in range(s0, s1)
        ]
        return jnp.stack(parts)
