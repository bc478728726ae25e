"""End-to-end multi-device frame compression.

The public sharded path: superblocks shard over the mesh, each device runs
the XLA block-codec encode locally, compressed sizes are combined with
an all-gather + cumsum (the collective replacement for the reference's
serial offset fix-up, stenos.cpp:977-990), and the frame is assembled in
device memory (the parallel-memcpy round, stenos.cpp:992-1004). Output is
byte-identical to the single-device path
(engine_jax.compress_frame_device_jit) and decodes with frame.decompress /
the C++ reference.

Multi-host: the same shard_map runs under jax.distributed with a global
mesh (tests/test_distributed.py drives a 2-process CPU cluster).
"""

from functools import lru_cache

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .sharding import encode_superblocks_sharded, make_mesh


@lru_cache(maxsize=64)
def _sharded_encode_gather_fn(mesh: Mesh, bpp: int, block_level: int,
                              axis: str):
    from ..engine_jax import encode_records_body

    def step(chunk):
        rows, totals, _, _ = encode_records_body(chunk, bpp, block_level)
        sizes = jax.lax.all_gather(totals, axis, tiled=True)
        offs = 8 + jnp.cumsum(sizes) - sizes
        rows_g = jax.lax.all_gather(rows, axis, tiled=True)
        return rows_g, sizes, offs.astype(jnp.int32)

    return jax.jit(jax.shard_map(
        step, mesh=mesh, in_specs=P(axis), out_specs=(P(), P(), P()),
        check_vma=False,
    ))


def _sharded_encode_gather(mesh: Mesh, data, bpp: int, block_level: int,
                           axis: str):
    sharding = NamedSharding(mesh, P(axis))
    data = jax.device_put(data, sharding)
    return _sharded_encode_gather_fn(mesh, bpp, block_level, axis)(data)


def compress_device_sharded(data, bpp: int, level: int = 1,
                            mesh: Mesh | None = None, axis: str = "chunks"):
    """Sharded device-resident frame compression — the ragged pipeline.

    data: (n_sb, sb) uint8 with n_sb a multiple of the mesh size (sb | the
    chosen superblock size). Returns (frame, frame_len): frame is a
    (nd*S,) uint8 array SHARDED over the mesh (device t holds bytes
    [t*S, (t+1)*S)); np.asarray(frame)[:frame_len] is byte-identical to
    engine_jax.compress_frame_device_jit's single-device frame.

    Pipeline (SURVEY §2.7): phase-1 shard_map encodes each device's
    superblocks and packs them into a contiguous local segment (parallel
    frame assembly — the reference's memcpy round, stenos.cpp:992-1004);
    only the nd segment lengths ride a collective. The host turns them
    into global offsets (the prefix-sum replacing stenos.cpp:977-990's
    serial walk) and a bucketed shard width sized from the MEASURED
    compressed bytes; phase-2 reduce_scatters the placed segments so
    per-device interconnect traffic is ~(nd-1)/nd of the compressed
    frame, not of the padded rows.
    """
    from ..engine_jax import _bucket125, frame_header_bytes
    from .sharding import assemble_frame_sharded, encode_segments_sharded

    n_sb, sb = data.shape
    mesh = mesh if mesh is not None else make_mesh()
    nd = mesh.devices.size
    if n_sb % nd:
        raise ValueError(f"n_sb={n_sb} not a multiple of mesh size {nd}")
    segs, seg_lens = encode_segments_sharded(
        mesh, data, bpp, 2 if level else 0, axis)
    seg_lens = np.asarray(seg_lens, np.int64)  # nd scalars D2H
    nbytes = n_sb * sb
    hdr = frame_header_bytes(nbytes, sb, bpp, level)
    base = len(hdr)
    offs = base + np.cumsum(seg_lens) - seg_lens
    total = base + int(seg_lens.sum())
    C_loc = segs.shape[1]
    # S: every segment must fit at its offset without DUS clamping
    S = _bucket125(-(-(total + C_loc) // nd))
    frame = assemble_frame_sharded(mesh, segs, offs, hdr, S, axis)
    return frame, total


def compress_device_sharded_gathered(data, bpp: int, level: int = 1,
                                     mesh: Mesh | None = None,
                                     axis: str = "chunks"):
    """The gathered variant (all_gather of padded rows + one-device
    assembly): the traffic A/B baseline for benchs/bench_scaling.py. Same
    byte output as the ragged path."""
    from ..engine_jax import _frame_assemble, frame_header_bytes

    n_sb, sb = data.shape
    mesh = mesh if mesh is not None else make_mesh()
    nd = mesh.devices.size
    if n_sb % nd:
        raise ValueError(f"n_sb={n_sb} not a multiple of mesh size {nd}")
    rows, sizes, offs = _sharded_encode_gather(
        mesh, data, bpp, 2 if level else 0, axis)
    nbytes = n_sb * sb
    hdr = frame_header_bytes(nbytes, sb, bpp, level)
    base = len(hdr)
    cap = base + n_sb * rows.shape[1]
    dev = mesh.devices.reshape(-1)[0]
    frame = _frame_assemble(jax.device_put(rows, dev),
                            jax.device_put(offs + (base - 8), dev),
                            jax.device_put(jnp.asarray(hdr), dev), cap)
    return frame, base + jnp.sum(sizes)


class ShardedEngine:
    """frame.py engine whose batched superblock pre-pass fans out over a
    device mesh: each device block-encodes its shard of superblocks
    locally, then method selection, LZ patch-up and the zstd entropy stage
    run on the gathered streams exactly as in the single-device path — so
    `compress(..., mesh=...)` output is byte-identical to the single-device
    frame at EVERY level, matching the reference thread pool which
    parallelizes ALL methods (stenos.cpp:909-1016), not just METHOD_BLOCK.

    Everything except encode_batch is borrowed from a JaxEngine."""

    def __init__(self, mesh: Mesh | None = None, axis: str = "chunks"):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.axis = axis

    def encode_batch(self, data, bpp: int, sb: int, block_level: int = 2):
        nbytes = len(data)
        n_sb = -(-nbytes // sb)
        n_full = nbytes // sb
        block_size = 256 * bpp
        if n_full == 0 or sb % block_size:
            return [None] * n_sb
        nd = self.mesh.devices.size
        n_pad = -(-n_full // nd) * nd
        batch = np.zeros((n_pad, sb), np.uint8)
        batch[:n_full] = np.asarray(data[: n_full * sb]).reshape(n_full, sb)
        out, total, bs, fs = encode_superblocks_sharded(
            self.mesh, batch, bpp, block_level, self.axis)
        out, total = np.asarray(out), np.asarray(total)
        bs, fs = np.asarray(bs), np.asarray(fs)
        pre = [(out[i], int(total[i]), bs[i], fs[i]) for i in range(n_full)]
        pre += [None] * (n_sb - n_full)
        return pre

    def __getattr__(self, name):
        # finish_block_stream / encode_block_stream / decode_block_stream /
        # _patch_lz state: borrow the single-device engine's host patch-up
        if name.startswith("__"):
            raise AttributeError(name)
        from ..engine_jax import JaxEngine

        local = self.__dict__.setdefault("_local", JaxEngine())
        return getattr(local, name)


def compress_sharded(data, bpp: int, level: int = 1,
                     mesh: Mesh | None = None, entropy=None) -> bytes:
    """Whole-input sharded compress -> complete frame bytes on host.

    data: 1-D bytes/uint8 array. Runs the standard frame layer with a
    ShardedEngine, so superblock sizing, the full §2.5 method-selection
    decision tree and the entropy stage all behave exactly like the
    single-device path at every level; only the block-codec pre-pass fans out
    over the mesh. Level 0 is a host memcpy frame (no device work)."""
    from .. import frame as fr

    if isinstance(data, (bytes, bytearray, memoryview)):
        data = np.frombuffer(bytes(data), np.uint8)
    data = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    if level == 0:
        return fr.compress(data, bpp, level)
    engine = ShardedEngine(mesh)
    return fr.compress(data, bpp, level, engine=engine, entropy=entropy)


def decompress_sharded(frame, bpp: int, mesh: Mesh | None = None,
                       axis: str = "chunks"):
    """Mesh-parallel frame decompression (the decompression fan-out of
    stenos.cpp:1151-1202): the host C++ batch parser builds the decode
    index, the virtual payloads shard over the mesh, and each device
    decodes its slice. Frames with other methods (entropy / COPY) take the
    single-device frame layer.

    Returns a uint8 numpy array of the decompressed bytes."""
    from .. import frame as fr

    frame = bytes(memoryview(np.asarray(frame))) if not isinstance(
        frame, (bytes, bytearray)) else bytes(frame)
    mesh = mesh if mesh is not None else make_mesh()
    r = _decode_frame_sharded(frame, bpp, mesh, axis)
    if r is not None:
        return r
    return fr.decompress(frame, bpp, engine="auto")


def _decode_frame_sharded(frame: bytes, bpp: int, mesh: Mesh, axis: str):
    """All-BLOCK frames -> decoded bytes; None for other methods."""
    from .. import frame as fr
    from ..constants import ERROR_INVALID_INPUT
    from ..engine_jax import _bucket125, block_records, decode_tail_record
    from ..native import lib as native
    from .sharding import decode_slabs_sharded

    dsize_total, sb, pos = fr.get_info(frame, bpp)
    block_size = 256 * bpp
    if dsize_total == 0 or sb % block_size:
        return None
    n_sb = dsize_total // sb  # full superblocks go on the mesh
    if n_sb == 0:
        return None
    nb = sb // block_size
    recs = block_records(frame, pos, n_sb)
    if recs is None:
        return None
    offs, csizes = recs
    p = offs[-1] + csizes[-1]
    row_bytes = _bucket125(max(csizes) + 512)
    r = native.parse_rows_batch(frame, bpp, sb, offs, csizes, row_bytes)
    if isinstance(r, int):
        raise fr.StenosError(ERROR_INVALID_INPUT)
    vbufs, po, rt, _ = r
    nd = mesh.devices.size
    n_pad = -(-n_sb // nd) * nd
    if n_pad != n_sb:  # pad by repeating the last slab (decoded, dropped)
        reps = n_pad - n_sb
        vbufs = np.concatenate([vbufs, np.repeat(vbufs[-1:], reps, 0)])
        po = np.concatenate([po, np.repeat(po[-1:], reps, 0)])
        rt = np.concatenate([rt, np.repeat(rt[-1:], reps, 0)])
    out = decode_slabs_sharded(mesh, vbufs, po, rt, bpp, nb, axis)
    out = np.asarray(out)[:n_sb].reshape(-1)
    if dsize_total > n_sb * sb:  # short final superblock: host ladder
        tail = decode_tail_record(frame, p, bpp, dsize_total - n_sb * sb)
        out = np.concatenate([out, tail])
    return out
