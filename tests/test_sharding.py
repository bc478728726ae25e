"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax

import stenos_tpu as st
from conftest import gen_elements


needs_mesh = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


@needs_mesh
def test_sharded_encode_matches_single(rng):
    from stenos_tpu.parallel import make_mesh, encode_superblocks_sharded
    from stenos_tpu.engine_jax import encode_superblocks_jit

    bpp = 4
    sb = 256 * bpp * 4
    n_sb = 16
    data = gen_elements(rng, bpp, (n_sb * sb) // bpp, "sorted")
    batch = np.frombuffer(data, np.uint8).reshape(n_sb, sb)

    mesh = make_mesh(8)
    out_s, tot_s, bs_s, fs_s = encode_superblocks_sharded(mesh, batch, bpp)
    out_1, tot_1, bs_1, fs_1 = encode_superblocks_jit(batch, bpp, 2)
    assert (np.asarray(tot_s) == np.asarray(tot_1)).all()
    assert (np.asarray(out_s) == np.asarray(out_1)).all()


@needs_mesh
def test_sharded_compress_step(rng):
    from stenos_tpu.parallel import make_mesh, sharded_compress_step

    bpp = 4
    sb = 256 * bpp * 2
    n_sb = 8
    data = gen_elements(rng, bpp, (n_sb * sb) // bpp, "sorted")
    batch = np.frombuffer(data, np.uint8).reshape(n_sb, sb)
    mesh = make_mesh(8)
    gathered, totals, offsets = sharded_compress_step(mesh, batch, bpp)
    gathered = np.asarray(gathered)
    totals = np.asarray(totals)
    # the gathered per-superblock streams decode back to the inputs
    from stenos_tpu.frame import _host_block_decode

    for i in range(n_sb):
        out = _host_block_decode(bytes(gathered[i][: totals[i]]), bpp, sb)
        assert not isinstance(out, int)
        assert out.tobytes() == batch[i].tobytes()
    # offsets are the exclusive prefix over framed sizes
    sizes = totals + 4
    expect = 8 + np.cumsum(sizes) - sizes
    assert (np.asarray(offsets) == expect).all()


@needs_mesh
def test_graft_dryrun():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


@needs_mesh
@pytest.mark.parametrize("pipeline", ["ragged", "gathered"])
def test_ragged_sharded_frame_matches_single(rng, pipeline):
    """Both sharded pipelines — ragged (local segment assembly +
    reduce_scatter of frame shards, output SHARDED over the mesh) and
    gathered (all_gather of padded rows + one-device assembly) — produce a
    frame byte-identical to the single-device path, and the ragged
    collective traffic model is proportional to the compressed (not
    padded) bytes."""
    from stenos_tpu.parallel import (compress_device_sharded,
                                     compress_device_sharded_gathered,
                                     make_mesh, ragged_traffic_model)
    from stenos_tpu.engine_jax import compress_frame_device_jit

    bpp = 4
    sb = 256 * bpp * 2
    n_sb = 16
    data = gen_elements(rng, bpp, (n_sb * sb) // bpp, "sorted")
    batch = np.frombuffer(data, np.uint8).reshape(n_sb, sb)
    mesh = make_mesh(8)
    if pipeline == "ragged":
        f_r, l_r = compress_device_sharded(batch, bpp, 1, mesh)
        # output is sharded over the mesh, not replicated
        from jax.sharding import PartitionSpec

        assert f_r.sharding.spec == PartitionSpec("chunks")
    else:
        f_r, l_r = compress_device_sharded_gathered(batch, bpp, 1, mesh)
    f_1, l_1 = compress_frame_device_jit(batch, bpp, 1)
    assert int(l_r) == int(l_1)
    assert (np.asarray(f_r)[: int(l_r)]
            == np.asarray(f_1)[: int(l_1)]).all()
    # frame decodes through the standard layer
    back = st.decompress(np.asarray(f_r)[: int(l_r)].tobytes(), bpp)
    assert back.tobytes() == data
    # traffic: ragged moves ~compressed bytes per chip, gathered ~padded
    m = ragged_traffic_model(n_sb=n_sb, w=sb + 512, nd=8,
                             S=(int(l_r) + sb) // 8 + 512,
                             C_loc=2 * (sb + 512))
    assert m["ragged_per_chip_bytes"] < m["gathered_per_chip_bytes"]


@needs_mesh
def test_sharded_pallas_encode_matches_single(rng):
    """The record encode under shard_map with all-gathered rows, sizes and
    offsets (the gathered pipeline's phase 1) produces the same records as
    the single-device XLA encode."""
    from stenos_tpu.engine_jax import encode_superblocks_jit
    from stenos_tpu.parallel import make_mesh
    from stenos_tpu.parallel.api import _sharded_encode_gather

    bpp = 4
    sb = 256 * bpp * 2
    n_sb = 8
    data = gen_elements(rng, bpp, (n_sb * sb) // bpp, "sorted")
    batch = np.frombuffer(data, np.uint8).reshape(n_sb, sb)

    mesh = make_mesh(8)
    rows, tot_s, offs = _sharded_encode_gather(mesh, batch, bpp, 2, "chunks")
    out_1, tot_1, _, _ = encode_superblocks_jit(batch, bpp, 2)
    rows = np.asarray(rows)
    tot_s = np.asarray(tot_s)
    for i in range(n_sb):
        want = (bytes([1]) + int(tot_1[i]).to_bytes(3, "little")
                + bytes(np.asarray(out_1[i])[: int(tot_1[i])]))
        assert bytes(rows[i][: tot_s[i]]) == want, i
    assert (np.asarray(offs) == 8 + np.cumsum(tot_s) - tot_s).all()


def test_public_mesh_compress(rng):
    """st.compress(..., mesh=) routes through the sharded production path
    and the result decodes like any frame (+ tail handling)."""
    import stenos_tpu as st
    from stenos_tpu.parallel import make_mesh

    from conftest import gen_elements

    data = gen_elements(rng, 4, (8 * 131072 + 5000) // 4, "sorted")
    mesh = make_mesh(4)
    frame = st.compress(data, 4, 1, mesh=mesh)
    assert st.decompress(frame, 4).tobytes() == data


@needs_mesh
@pytest.mark.parametrize("level", [1, 2, 5])
@pytest.mark.parametrize("kind", ["sorted", "random", "rle"])
def test_mesh_compress_bytes_equal_single_chip(rng, level, kind):
    """compress(..., mesh=...) runs the FULL decision tree (method
    selection + zstd entropy stage) per superblock, so the mesh frame is
    byte-identical to the single-device frame at every level — the reference
    thread pool parallelizes all methods (stenos.cpp:909-1016)."""
    import stenos_tpu as st
    from stenos_tpu import frame as fr
    from stenos_tpu.parallel import make_mesh

    bpp = 4
    # 3.25 superblocks at the level's standard superblock size: exercises
    # the sharded grid, the non-multiple remainder and the partial tail
    sb, _ = fr._superblock_params(bpp, 1 << 22, level)
    data = gen_elements(rng, bpp, (3 * sb + sb // 4) // bpp, kind)
    mesh = make_mesh(8)
    sharded = st.compress(data, bpp, level, mesh=mesh)
    single = fr.compress(data, bpp, level)
    assert sharded == single, (level, kind)
    assert st.decompress(sharded, bpp).tobytes() == data


@needs_mesh
@pytest.mark.parametrize("level", [1, 2])
def test_mesh_decompress(rng, level):
    """decompress(..., mesh=...) fans the decode out over the mesh
    (all-BLOCK frames take the sharded kernel path; mixed-method frames
    fall back per record) and matches the input bit-exactly."""
    import stenos_tpu as st
    from stenos_tpu.parallel import make_mesh

    bpp = 4
    data = gen_elements(rng, bpp, (6 * 131072 + 7000) // bpp, "sorted")
    mesh = make_mesh(8)
    frame = st.compress(data, bpp, level)
    out = st.decompress(frame, bpp, mesh=mesh)
    assert out.tobytes() == data
