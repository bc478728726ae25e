"""Chunk-data-parallel compression over a device mesh.

The reference's only parallelism is a host thread pool over independent
superblocks (tiny_pool.h, stenos.cpp:909-1016). The equivalent here shards
the superblock batch across devices with shard_map over a 1-D mesh: each
device block-compresses its superblocks locally, then the variable-length
results are combined with XLA collectives — a prefix-sum over compressed
sizes replacing the reference's serial offset walk, and an all-gather or
reduce_scatter of the streams over the interconnect. The mesh is
topology-free: every device reaches every other at the same rate.

Multi-host: the same code runs under jax.distributed with a global mesh; the
frame layer only consumes the gathered sizes/streams on host 0.
"""

from functools import lru_cache

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..engine_jax import (decode_slabs_jit, encode_records_body,
                          encode_superblocks_body)


def make_mesh(n_devices: int | None = None, axis: str = "chunks") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def encode_superblocks_sharded(mesh: Mesh, data, bpp: int,
                               block_level: int = 2, axis: str = "chunks"):
    """Shard (n_sb, sb) superblocks over the mesh and encode locally.

    Returns (streams, totals, block_sizes, full_sizes) with the same global
    shapes as the single-device encoder; XLA keeps them sharded until
    consumed.
    """

    def local(chunk):
        return encode_superblocks_body(chunk, bpp, block_level)

    f = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=P(axis),
        out_specs=(P(axis), P(axis), P(axis), P(axis)),
    )
    sharding = NamedSharding(mesh, P(axis))
    data = jax.device_put(data, sharding)
    return jax.jit(f)(data)


def decode_slabs_sharded(mesh: Mesh, vbufs, plane_off, rowtab, bpp: int,
                         nb: int, axis: str = "chunks"):
    """Mesh-parallel slab decode: shard the (n_rows, row_bytes) virtual
    payloads (from the C++ batch row parser) over the mesh and decode
    locally on each device's slice — the decompression fan-out of the
    reference's thread pool (stenos.cpp:1151-1202). n_rows must be a
    multiple of the mesh size (callers pad by repeating the last row).

    Returns (n_rows, nb*256*bpp) uint8, sharded until consumed."""

    def local(vb, po, rt):
        return decode_slabs_jit(vb, po, rt, bpp, nb)

    f = jax.shard_map(
        local,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis)),
        out_specs=P(axis),
        check_vma=False,  # the decoder's scan carry starts unvarying
    )
    sharding = NamedSharding(mesh, P(axis))
    args = [jax.device_put(np.ascontiguousarray(x), sharding)
            for x in (vbufs, plane_off, rowtab)]
    return jax.jit(f)(*args)


def sharded_compress_step(mesh: Mesh, data, bpp: int, axis: str = "chunks"):
    """One full sharded compress 'step' (used by dryrun_multichip and the
    scaling bench): local block-encode + collective size prefix-sum +
    all-gather of the padded streams — the collective form of the
    reference's serial offset fix-up + parallel memcpy (stenos.cpp:977-1004).

    This is the GATHERED variant (padded rows replicated to every device);
    the production path is the ragged pipeline below
    (encode_segments_sharded + assemble_frame_sharded), whose collective
    traffic is proportional to the COMPRESSED size. Kept for parity tests
    and as the traffic A/B baseline in benchs/bench_scaling.py.

    Returns (gathered_streams, totals, offsets) replicated on all devices.
    """

    def step(chunk):
        out, total, bsizes, fsizes = encode_superblocks_body(chunk, bpp, 2)
        # global ordered offsets of every superblock: ragged sizes -> psum /
        # cumsum over the gathered size vector
        all_totals = jax.lax.all_gather(total, axis, tiled=True)
        frame_sizes = all_totals + 4
        offsets = 8 + jnp.cumsum(frame_sizes) - frame_sizes
        gathered = jax.lax.all_gather(out, axis, tiled=True)
        return gathered, all_totals, offsets

    f = jax.shard_map(
        step,
        mesh=mesh,
        in_specs=P(axis),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    sharding = NamedSharding(mesh, P(axis))
    data = jax.device_put(data, sharding)
    return jax.jit(f)(data)


# ---------------------------------------------------------------------------
# Ragged, size-aware multi-device frame pipeline (SURVEY §2.7: "prefix-sum
# over compressed sizes + ragged all-gather"). Two dispatches:
#
#   phase 1  encode_segments_sharded — each device block-encodes its shard
#            of superblocks AND assembles its own contiguous frame segment
#            locally (zero-masked row padding + per-row dynamic_update_slice
#            copies: the reference's parallel memcpy round,
#            stenos.cpp:992-1004, actually parallel across devices here).
#            The only collective is an all-gather of nd segment LENGTHS.
#
#   host     nd-scalar readback -> global segment offsets (the prefix-sum
#            replacing the reference's serial offset walk,
#            stenos.cpp:977-990) -> bucketed shard width S sized from the
#            MEASURED compressed bytes.
#
#   phase 2  assemble_frame_sharded — each device places its segment at its
#            global offset in a zeroed (nd*S,) contribution and ONE
#            psum_scatter (reduce_scatter) leaves device t holding frame
#            bytes [t*S, (t+1)*S): per-device traffic ~= (nd-1)/nd of the
#            COMPRESSED frame (vs the gathered variant's (nd-1)/nd of the
#            PADDED/uncompressed bytes, replicated nd ways), and the output
#            stays sharded instead of replicated.
# ---------------------------------------------------------------------------


def _local_segment(rows, totals):
    """Pack padded rows into one contiguous local segment (zero tail).

    Row padding is zero-masked first so the segment can later be SUMMED
    into the sharded frame (overlapping pad regions contribute zeros)."""
    n_loc, w = rows.shape
    lane = jax.lax.broadcasted_iota(jnp.int32, (n_loc, w), 1)
    rows = jnp.where(lane < totals[:, None], rows, 0)
    offs = (jnp.cumsum(totals) - totals).astype(jnp.int32)
    seg = jnp.zeros(n_loc * w, jnp.uint8)

    def body(i, s):
        return jax.lax.dynamic_update_slice(
            s, jax.lax.dynamic_index_in_dim(rows, i, keepdims=False),
            (offs[i],))

    return jax.lax.fori_loop(0, n_loc, body, seg), totals.sum()


@lru_cache(maxsize=64)
def _encode_segments_fn(mesh: Mesh, bpp: int, block_level: int, axis: str):
    def step(chunk):
        rows, totals, _, _ = encode_records_body(chunk, bpp, block_level)
        seg, ln = _local_segment(rows, totals)
        lens = jax.lax.all_gather(ln.astype(jnp.int32)[None], axis,
                                  tiled=True)
        return seg[None], lens

    return jax.jit(jax.shard_map(
        step, mesh=mesh, in_specs=P(axis), out_specs=(P(axis), P()),
        check_vma=False,
    ))


def encode_segments_sharded(mesh: Mesh, data, bpp: int, block_level: int = 2,
                            axis: str = "chunks"):
    """Phase 1 of the ragged pipeline. data: (n_sb, sb) with n_sb a multiple
    of the mesh size. Returns (segs, seg_lens):
      segs     (nd, n_local*w) uint8, sharded P(axis) — device-local
               contiguous frame segments (zero-padded tails), NOT gathered;
      seg_lens (nd,) int32, replicated — the only collective of this phase.
    """
    sharding = NamedSharding(mesh, P(axis))
    data = jax.device_put(data, sharding)
    return _encode_segments_fn(mesh, bpp, block_level, axis)(data)


@lru_cache(maxsize=64)
def _assemble_fn(mesh: Mesh, S: int, hdr_len: int, axis: str):
    nd = mesh.devices.size

    def step(seg, offs, hdr):
        idx = jax.lax.axis_index(axis)
        contrib = jnp.zeros(nd * S, jnp.uint8)
        h = jnp.where(idx == 0, hdr, jnp.zeros_like(hdr))
        contrib = jax.lax.dynamic_update_slice(contrib, h, (0,))
        contrib = jax.lax.dynamic_update_slice(contrib, seg[0], (offs[idx],))
        return jax.lax.psum_scatter(contrib, axis, scatter_dimension=0,
                                    tiled=True)

    return jax.jit(jax.shard_map(
        step, mesh=mesh, in_specs=(P(axis), P(), P()), out_specs=P(axis),
        check_vma=False,
    ))


def assemble_frame_sharded(mesh: Mesh, segs, seg_offs, header, S: int,
                           axis: str = "chunks"):
    """Phase 2: reduce_scatter the ragged segments into a sharded frame.

    segs (nd, C_loc) sharded P(axis); seg_offs (nd,) global byte offsets
    (header included); header: frame header bytes; S: bytes per shard
    (static; host picks a bucket >= (len(header)+sum+C_loc)/nd).

    Returns frame (nd*S,) uint8 sharded P(axis): device t holds global bytes
    [t*S, (t+1)*S). np.asarray(frame) materializes it on the host.
    """
    hdr = jnp.asarray(np.asarray(header, np.uint8))
    offs = jnp.asarray(np.asarray(seg_offs, np.int32))
    return _assemble_fn(mesh, S, len(header), axis)(segs, offs, hdr)


def ragged_traffic_model(n_sb: int, w: int, nd: int, S: int,
                         C_loc: int) -> dict:
    """Per-device interconnect bytes moved by each path's collectives
    (ring model: an all-gather or reduce_scatter of a B-byte global buffer
    moves (nd-1)/nd * B bytes through each device). The scaling bench
    records this next to the measured wall times."""
    gathered = (nd - 1) / nd * (n_sb * w)          # all_gather(padded rows)
    ragged = (nd - 1) / nd * (nd * S) + 4 * nd     # reduce_scatter + lens
    return {
        "gathered_per_chip_bytes": int(gathered),
        "ragged_per_chip_bytes": int(ragged),
        "ratio": round(gathered / max(ragged, 1), 3),
        "padded_rows_bytes": n_sb * w,
        "frame_shards_bytes": nd * S,
        "local_segment_bytes": C_loc,
    }
