"""Loader for the native host runtime.

The library is built from the committed src/stenos_native.cpp with g++ on
first import, into build/ beside this file (git-ignored), under a name
keyed by a hash of the source and of the host CPU (the build uses
-march=native). A failed build raises: the host runtime is required.

ctypes-based; every call releases the GIL so the frame layer can fan
superblocks out over threads, mirroring the reference's tiny_pool fan-out
at the host-runtime level while the block codec itself runs on the device.
"""

import ctypes
import hashlib
import os
import subprocess

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "stenos_native.cpp")


class _Native:
    def __init__(self, cdll):
        self._lib = cdll
        cdll.stn_lz4_guess_size.restype = ctypes.c_size_t
        cdll.stn_lz4_guess_size.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int]
        cdll.stn_block_decode.restype = ctypes.c_ssize_t
        cdll.stn_block_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_size_t, ctypes.c_void_p, ctypes.c_void_p]
        for name in ("stn_shuffle", "stn_unshuffle"):
            fn = getattr(cdll, name)
            fn.restype = None
            fn.argtypes = [ctypes.c_size_t, ctypes.c_size_t,
                           ctypes.c_void_p, ctypes.c_void_p]
        for name in ("stn_delta", "stn_delta_inv"):
            fn = getattr(cdll, name)
            fn.restype = None
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
        cdll.stn_parse_index.restype = ctypes.c_ssize_t
        cdll.stn_parse_index.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_size_t, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        cdll.stn_parse_rows.restype = ctypes.c_ssize_t
        cdll.stn_parse_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_size_t, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_size_t, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        cdll.stn_huff_lengths.restype = None
        cdll.stn_huff_lengths.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int32,
            ctypes.c_void_p]
        cdll.stn_huff_tree_descs.restype = None
        cdll.stn_huff_tree_descs.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_void_p]
        cdll.stn_parse_rows_batch.restype = ctypes.c_ssize_t
        cdll.stn_parse_rows_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_size_t, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        cdll.stn_zstd_ctx_size.restype = ctypes.c_size_t
        cdll.stn_zstd_ctx_size.argtypes = []
        cdll.stn_zstd_seqs.restype = ctypes.c_ssize_t
        cdll.stn_zstd_seqs.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_size_t]
        cdll.stn_huf_lits.restype = ctypes.c_ssize_t
        cdll.stn_huf_lits.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
            ctypes.c_int, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_void_p]
        cdll.stn_huf_anchors.restype = ctypes.c_ssize_t
        cdll.stn_huf_anchors.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        cdll.stn_huf_tree_lens.restype = ctypes.c_ssize_t
        cdll.stn_huf_tree_lens.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p]
        cdll.stn_seq_ops.restype = ctypes.c_ssize_t
        cdll.stn_seq_ops.argtypes = [
            ctypes.c_size_t, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_size_t]
        cdll.stn_fse_ctable.restype = ctypes.c_ssize_t
        cdll.stn_fse_ctable.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        cdll.stn_matchiness.restype = ctypes.c_double
        cdll.stn_matchiness.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_size_t]
        cdll.stn_match_parse.restype = ctypes.c_ssize_t
        cdll.stn_match_parse.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        cdll.stn_encode_block.restype = ctypes.c_ssize_t
        cdll.stn_encode_block.argtypes = [
            ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_size_t]

    def lz4_guess_size(self, data, accel: int) -> int:
        data = bytes(data)
        return self._lib.stn_lz4_guess_size(data, len(data), accel)

    def parse_index(self, src, bpp: int, nbytes: int):
        """Build the device-decode index for a block stream.

        Returns (plane_off i32[P], plane_kind u8[P], plane_val u8[P],
        patch u8[patch_len], tail_off, tail_len, consumed) or negative error.
        P = nb*bpp. Offsets >= len(src) address the patch area.
        """
        import numpy as np

        src = bytes(src)
        block_size = 256 * bpp
        nb = 1 if nbytes == block_size else nbytes // block_size
        P = max(nb * bpp, 1)
        plane_off = np.zeros(P, dtype=np.int32)
        plane_kind = np.zeros(P, dtype=np.uint8)
        plane_val = np.zeros(P, dtype=np.uint8)
        patch_cap = nbytes + block_size
        patch = np.empty(patch_cap, dtype=np.uint8)
        patch_len = np.zeros(1, dtype=np.int64)
        tail_info = np.zeros(2, dtype=np.int64)
        scratch = np.empty(512 * bpp + 16, dtype=np.uint8)
        as_p = lambda a: a.ctypes.data_as(ctypes.c_void_p)
        r = self._lib.stn_parse_index(
            src, len(src), bpp, nbytes, as_p(plane_off), as_p(plane_kind),
            as_p(plane_val), as_p(patch), patch_cap, as_p(patch_len),
            as_p(tail_info), as_p(scratch))
        if r < 0:
            return int(r)
        return (plane_off, plane_kind, plane_val,
                patch[: int(patch_len[0])], int(tail_info[0]),
                int(tail_info[1]), int(r))

    def parse_rows(self, src, bpp: int, nbytes: int):
        """Row-level decode index for the device decoder.

        Returns (vbuf, plane_off i32[P], row_rel i32[P,16], row_hdr u8[P,16],
        row_min u8[P,16], tail_bytes, consumed) or a negative error. vbuf is
        the VIRTUAL stream: the payload with LZ/COPY blocks replaced inline
        by decoded shuffled planes; plane_off indexes vbuf, row_rel is
        relative to each plane's offset. tail_bytes = decoded partial tail.
        """
        import numpy as np

        src = bytes(src)
        block_size = 256 * bpp
        nb = 1 if nbytes == block_size else nbytes // block_size
        P = max(nb * bpp, 1)
        row_hdr = np.zeros(P * 16, dtype=np.uint8)
        row_min = np.zeros(P * 16, dtype=np.uint8)
        row_rel = np.zeros(P * 16, dtype=np.int32)
        plane_off = np.zeros(P, dtype=np.int32)
        patch_cap = nbytes + 2 * block_size
        patch = np.empty(patch_cap, dtype=np.uint8)
        patch_len = np.zeros(1, dtype=np.int64)
        tail_info = np.zeros(2, dtype=np.int64)
        splices = np.zeros((max(nb, 1), 3), dtype=np.int64)
        n_splices = np.zeros(1, dtype=np.int64)
        scratch = np.empty(512 * bpp + 16, dtype=np.uint8)
        as_p = lambda a: a.ctypes.data_as(ctypes.c_void_p)
        r = self._lib.stn_parse_rows(
            src, len(src), bpp, nbytes, as_p(row_hdr), as_p(row_min),
            as_p(row_rel), as_p(plane_off), as_p(patch), patch_cap,
            as_p(patch_len), as_p(tail_info), as_p(splices),
            as_p(n_splices), as_p(scratch))
        if r < 0:
            return int(r)
        stream = np.frombuffer(src, np.uint8)
        nspl = int(n_splices[0])
        if nspl:
            pieces = []
            prev = 0
            for k in range(nspl):
                sp, skip, ppos = splices[k]
                pieces.append(stream[prev:sp])
                pieces.append(patch[ppos : ppos + block_size])
                prev = sp + skip
            pieces.append(stream[prev:])
            vbuf = np.concatenate(pieces)
        else:
            vbuf = stream
        tail = patch[int(tail_info[0]) : int(tail_info[0]) + int(tail_info[1])] \
            if tail_info[1] else np.zeros(0, np.uint8)
        return (vbuf, plane_off, row_rel.reshape(P, 16),
                row_hdr.reshape(P, 16), row_min.reshape(P, 16), tail, int(r))

    def parse_rows_batch(self, frame, bpp: int, sb: int, offs, csizes,
                         row_bytes: int, bufs=None):
        """Batched decode index for full method-BLOCK superblocks.

        frame: whole frame bytes; offs/csizes: per-superblock payload spans.
        Returns (vbufs (n,row_bytes) u8, plane_off (n,P) i32,
        rowtab (n,16,P) i32 packed rel|hdr<<10|min<<14,
        vlens (n,) i64 per-superblock VIRTUAL lengths) or a negative error.
        vlens can exceed csize: LZ/COPY blocks are inlined expanded — always
        bound the virtual stream by vlens, never by csize.
        bufs: optional preallocated (vbufs, plane_off, rowtab) to write into
        (page-warm reuse — fresh allocations fault ~40 MB/call on this host).
        If row_bytes is too small for the expanded stream and bufs is not
        pinned, retries once at the worst-case bound (csize + sb per record).
        """
        import numpy as np

        frame = bytes(frame)
        n_sb = len(offs)
        P = sb // 256
        if bufs is not None:
            vbufs, plane_off, rowtab = bufs
        else:
            vbufs = np.empty((n_sb, row_bytes), np.uint8)
            plane_off = np.empty((n_sb, P), np.int32)
            rowtab = np.empty((n_sb, 16, P), np.int32)
        offs = np.ascontiguousarray(offs, np.int64)
        csizes = np.ascontiguousarray(csizes, np.int64)
        vlens = np.zeros(n_sb, np.int64)
        scratch = np.empty(512 * bpp + 16, np.uint8)
        as_p = lambda a: a.ctypes.data_as(ctypes.c_void_p)
        r = self._lib.stn_parse_rows_batch(
            frame, len(frame), bpp, sb, n_sb, as_p(offs), as_p(csizes),
            row_bytes, as_p(vbufs), as_p(plane_off), as_p(rowtab),
            as_p(vlens), as_p(scratch))
        if r == -4 and row_bytes < int(csizes.max()) + sb:  # ERR_INPUT
            # LZ inlining expanded past row_bytes: retry at the hard bound
            # (each block inflates by at most 256*bpp over its stream bytes)
            wide = int(csizes.max()) + sb + 16
            return self.parse_rows_batch(frame, bpp, sb, list(offs),
                                         list(csizes), wide)
        if r < 0:
            return int(r)
        return vbufs, plane_off, rowtab, vlens

    def huff_lengths(self, counts, max_bits: int = 11):
        """counts (n, 256) int64 -> length-limited Huffman lengths (n, 256)."""
        import numpy as np

        counts = np.ascontiguousarray(counts, np.int64)
        n = counts.shape[0]
        out = np.zeros((n, 256), np.uint8)
        self._lib.stn_huff_lengths(
            counts.ctypes.data_as(ctypes.c_void_p), n, max_bits,
            out.ctypes.data_as(ctypes.c_void_p))
        return out.astype(np.int32)

    def huff_tree_descs(self, lengths):
        """lengths (n, 256) -> list of serialized tree descriptions
        (None where the block must fall back to raw literals)."""
        import numpy as np

        lengths = np.ascontiguousarray(lengths, np.uint8)
        n = lengths.shape[0]
        out = np.zeros((n, 132), np.uint8)
        sizes = np.zeros(n, np.int32)
        self._lib.stn_huff_tree_descs(
            lengths.ctypes.data_as(ctypes.c_void_p), n,
            out.ctypes.data_as(ctypes.c_void_p),
            sizes.ctypes.data_as(ctypes.c_void_p))
        return [bytes(out[i][: sizes[i]]) if sizes[i] else None
                for i in range(n)]

    def zstd_ctx(self):
        """Fresh per-frame zstd decode context (Repeat_Mode FSE tables and
        Treeless_Literals huffman table persist across blocks in it)."""
        import numpy as np

        return np.zeros(int(self._lib.stn_zstd_ctx_size()), np.uint8)

    def zstd_seqs(self, sec, reps, ctx, cap: int = 0x20000):
        """Decode one sequences section (RFC 8878 §3.1.1.3.2).

        sec: section bytes (nseq header .. bitstream end); reps: (3,) int64
        running repeat-offset registers, updated in place.
        Returns (ll i32[n], ml i32[n], off i64[n]) or a negative error."""
        import numpy as np

        sec = bytes(sec)
        ll = np.empty(cap, np.int32)
        ml = np.empty(cap, np.int32)
        off = np.empty(cap, np.int64)
        as_p = lambda a: a.ctypes.data_as(ctypes.c_void_p)
        r = self._lib.stn_zstd_seqs(sec, len(sec), as_p(reps), as_p(ctx),
                                    as_p(ll), as_p(ml), as_p(off), cap)
        if r < 0:
            return int(r)
        return ll[:r], ml[:r], off[:r]

    def fse_ctable(self, norm, table_log: int):
        """FSE compression table (tANS spread + deltas) — native twin of
        fse.build_ctable's sequential spread loop. Returns
        (state_table (size,) int64, dnb (S,) int64, dfs (S,) int64) or a
        negative error."""
        import numpy as np

        norm = np.ascontiguousarray(norm, np.int32)
        n_sym = len(norm)
        state = np.zeros(512, np.int32)
        dnb = np.zeros(64, np.int64)
        dfs = np.zeros(64, np.int64)
        as_p = lambda a: a.ctypes.data_as(ctypes.c_void_p)
        r = self._lib.stn_fse_ctable(as_p(norm), n_sym, table_log,
                                     as_p(state), as_p(dnb), as_p(dfs))
        if r < 0:
            return int(r)
        return (state[: 1 << table_log].astype(np.int64), dnb[:n_sym],
                dfs[:n_sym])

    def huf_lits(self, src, four: bool, treeless: bool, regenerated: int,
                 ctx):
        """Huffman literals payload (tree desc + streams) -> uint8 array."""
        import numpy as np

        src = bytes(src)
        out = np.empty(max(regenerated, 1), np.uint8)
        r = self._lib.stn_huf_lits(
            src, len(src), int(four), int(treeless), regenerated,
            ctx.ctypes.data_as(ctypes.c_void_p),
            out.ctypes.data_as(ctypes.c_void_p))
        if r < 0:
            return int(r)
        return out[:regenerated]

    def huf_anchors(self, sec, regenerated: int, ctx):
        """Length-only anchor scan of a foreign 4-stream huffman literals
        section (bytes AFTER the 3/5-byte literals header): returns
        (lens (256,) uint8, anchors (4, 256) int32) in the decode-anchor
        sidecar contract, or a negative int error. Updates ctx's table
        like huf_lits would (treeless continuation stays correct)."""
        import numpy as np

        sec = bytes(sec)
        lens = np.zeros(256, np.uint8)
        anch = np.zeros((4, 256), np.int32)
        as_p = lambda a: a.ctypes.data_as(ctypes.c_void_p)
        r = self._lib.stn_huf_anchors(
            sec, len(sec), regenerated,
            ctx.ctypes.data_as(ctypes.c_void_p), as_p(lens), as_p(anch))
        if r < 0:
            return int(r)
        return lens, anch

    def huf_tree_lens(self, src):
        """Literals tree description -> (lens (256,) uint8, desc bytes)
        or a negative error int. The exact code lengths the section was
        encoded with (no host table rebuild)."""
        import numpy as np

        src = bytes(src)
        out = np.zeros(256, np.uint8)
        r = self._lib.stn_huf_tree_lens(
            src, len(src), out.ctypes.data_as(ctypes.c_void_p))
        if r < 0:
            return int(r)
        return out, int(r)

    def seq_ops(self, ll, ml, off, dst_base: int, lit_base: int,
                trailing: int, out_limit: int, W: int = 512):
        """Build the W-chunked copy-op program for one block's sequences.

        Returns (nops, 3) int32 ops (dst, src, flag: 1 = literal source) or
        a negative error. Ops are destination-ordered; execution relies on
        the ordered-overwrite invariant (entropy/seq_exec.py)."""
        import numpy as np

        ll = np.ascontiguousarray(ll, np.int32)
        ml = np.ascontiguousarray(ml, np.int32)
        off = np.ascontiguousarray(off, np.int64)
        n = len(ll)
        total = int(ll.sum() + ml.sum()) + int(trailing)
        # worst case per sequence: one ll op + log2(W) overlap-bootstrap
        # ops before the stride reaches W, plus the W-stride bulk ops
        cap = (W.bit_length() + 3) * max(n, 1) + total // W + 64
        ops = np.empty((cap, 3), np.int32)
        as_p = lambda a: a.ctypes.data_as(ctypes.c_void_p)
        r = self._lib.stn_seq_ops(n, as_p(ll), as_p(ml), as_p(off),
                                  dst_base, lit_base, trailing, out_limit,
                                  W, as_p(ops), cap)
        if r < 0:
            return int(r)
        return ops[:r]

    def matchiness(self, data, sample_n: int = 16384) -> float:
        """Duplicate-4-gram fraction of the block's first sample_n
        positions (host routing twin of match_device.matchiness)."""
        import numpy as np

        data = np.ascontiguousarray(data, np.uint8)
        return float(self._lib.stn_matchiness(
            data.ctypes.data_as(ctypes.c_void_p), len(data), sample_n))

    def match_parse(self, data, cand=None, reps=(1, 4, 8)):
        """Greedy LZ77 parse of one block (<= 128 KiB): exact nearest-
        previous-fp4 map walk (cand None, twin of match.greedy_parse) or
        the device candidate-array walk (twin of
        match_device._parse_py). reps: running repeat-offset registers
        (the walk is rep-aware). Returns (seqs, lits) or None."""
        import numpy as np

        data = np.ascontiguousarray(data, np.uint8)
        n = len(data)
        use = 0 if cand is None else 1
        carr = np.zeros(1, np.int32) if cand is None else \
            np.ascontiguousarray(cand, np.int32)
        cap = n // 3 + 16
        seqs = np.empty((cap, 3), np.int32)
        lits = np.empty(n + 16, np.uint8)
        nlits = np.zeros(1, np.int64)
        rarr = np.asarray(reps, np.int64)
        as_p = lambda a: a.ctypes.data_as(ctypes.c_void_p)
        r = self._lib.stn_match_parse(as_p(data), n, as_p(carr), use,
                                      as_p(seqs), cap, as_p(lits),
                                      as_p(nlits), as_p(rarr))
        if r <= 0:
            return None
        return ([tuple(int(v) for v in t) for t in seqs[:r]],
                lits[: int(nlits[0])].copy())

    def encode_block(self, data, last: bool, reps, cand=None):
        """One whole zstd block (twin of zstd_frame.encode_block; output
        byte-identical — tested). reps: (3,) int64 running repeat-offset
        registers, updated in place to the chosen candidate's state."""
        import numpy as np

        data = np.ascontiguousarray(data, np.uint8)
        n = len(data)
        use = 0 if cand is None else 1
        carr = np.zeros(1, np.int32) if cand is None else \
            np.ascontiguousarray(cand, np.int32)
        out = np.empty(n + 32, np.uint8)
        as_p = lambda a: a.ctypes.data_as(ctypes.c_void_p)
        r = self._lib.stn_encode_block(as_p(data), n, as_p(carr), use,
                                       int(last), as_p(reps), as_p(out),
                                       out.size)
        if r < 0:
            raise RuntimeError(f"stn_encode_block: {r}")
        return bytes(out[:r])

    def block_decode(self, src, bpp: int, nbytes: int):
        """Decode a block stream -> numpy uint8 array or negative error."""
        import numpy as np

        src = bytes(src)
        dst = np.empty(nbytes, dtype=np.uint8)
        scratch = np.empty(256 * bpp, dtype=np.uint8)
        r = self._lib.stn_block_decode(
            src, len(src), bpp, nbytes,
            dst.ctypes.data_as(ctypes.c_void_p),
            scratch.ctypes.data_as(ctypes.c_void_p))
        if r < 0:
            return int(r)
        return dst


_FLAGS = ["-O3", "-march=native", "-std=c++17", "-DNDEBUG", "-shared",
          "-fPIC", "-fvisibility=hidden"]


def _build(libpath: str) -> None:
    os.makedirs(os.path.dirname(libpath), exist_ok=True)
    # per-PID temp: concurrent builds (xdist workers) must not scribble
    # each other's half-written .so before the atomic os.replace
    tmp = f"{libpath}.tmp.{os.getpid()}.so"
    r = subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"native build failed:\n{r.stderr}")
    os.replace(tmp, libpath)


def _cpu_key() -> bytes:
    """The host CPU's model and feature flags (what -march=native reads)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return b""
    return b"\n".join(sorted({ln for ln in lines
                              if ln.startswith((b"model name", b"flags"))}))


def _load():
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_FLAGS).encode())
    h.update(_cpu_key())
    libpath = os.path.join(_HERE, "build",
                           f"stenos_native_{h.hexdigest()[:16]}.so")
    if not os.path.exists(libpath):
        _build(libpath)
    return _Native(ctypes.CDLL(libpath))


lib = _load()
