"""Foreign-frame literals decode on DEVICE (VERDICT r3 item 6 / r4):
for libzstd-made blocks with 4-stream Huffman literals and no sidecar, the
host emits decode anchors via a length-only stream scan (stn_huf_anchors)
and the existing anchored kernel produces the bytes — zero host literal
materialization for qualifying blocks (reference decodes all payloads
uniformly, stenos.cpp:694-753)."""

import numpy as np
import pytest
import zstandard as zstd

import stenos_tpu.entropy.device_decode as dd
from stenos_tpu.native import lib

pytestmark = pytest.mark.skipif(
    lib is None or not hasattr(lib, "huf_anchors"),
    reason="native runtime missing")


def _mk_text(n):
    """Log-like lines: repeated field names (matches) + random hex ids
    (large Huffman-coded literal sections at every zstd level)."""
    rng = np.random.default_rng(11)
    lines = []
    total = 0
    while total < n:
        h = rng.integers(0, 16, 24)
        ident = bytes(b"0123456789abcdef"[i] for i in h)
        line = b"time=17%b level=info request_id=%b bytes=%d\n" % (
            str(int(rng.integers(10**8, 10**9))).encode(), ident,
            int(rng.integers(0, 10**6)))
        lines.append(line)
        total += len(line)
    return b"".join(lines)[:n]


def test_huf_anchors_matches_postdoc_reference():
    """stn_huf_anchors on OUR OWN encoder's section must equal the post-hoc
    sidecar entry (same lens, same anchors) — the contract is shared."""
    from stenos_tpu.entropy.zstd_frame import (_block_anchor_entry,
                                               encode_block)

    rng = np.random.default_rng(3)
    data = rng.integers(0, 48, 131072).astype(np.uint8)
    data[rng.integers(0, 131072, 4096)] = rng.integers(0, 256, 4096)
    blk, _ = encode_block(data, True)
    ent = _block_anchor_entry(blk)
    assert ent is not None
    lens_ref, anch_ref = ent

    from stenos_tpu.entropy.zstd_parse import BlockSpec, _parse_sections

    spec = BlockSpec(2, 3, len(blk) - 3, 0)
    assert _parse_sections(blk, spec) is not None
    lit = spec.lit
    sec = blk[lit.off : lit.off + lit.length]
    r = lib.huf_anchors(sec, lit.regenerated, lib.zstd_ctx())
    assert not isinstance(r, int), f"huf_anchors error {r}"
    lens, anch = r
    assert np.array_equal(lens.astype(np.int64), np.asarray(lens_ref))
    assert np.array_equal(anch, anch_ref)


@pytest.mark.parametrize("level", [1, 3])
def test_foreign_literals_decode_on_device(level, monkeypatch):
    """A libzstd frame decodes through decode_payload_device with huf_lits
    never called for 4-stream tree-bearing blocks (their literals come from
    the anchored kernel)."""
    data = _mk_text(400_000)
    payload = zstd.ZstdCompressor(level=level).compress(data)

    calls = {"huf_lits": 0, "huf_anchors": 0}
    real_lits = lib.huf_lits
    real_anch = lib.huf_anchors

    def spy_lits(src, four, treeless, regenerated, ctx):
        if four and not treeless and regenerated >= 64:
            calls["huf_lits"] += 1
        return real_lits(src, four, treeless, regenerated, ctx)

    def spy_anch(sec, regenerated, ctx):
        calls["huf_anchors"] += 1
        return real_anch(sec, regenerated, ctx)

    monkeypatch.setattr(lib, "huf_lits", spy_lits)
    monkeypatch.setattr(lib, "huf_anchors", spy_anch)
    out = dd.decode_payload_device(payload, len(data))
    assert out is not None, "fell back to host"
    assert np.asarray(out).tobytes() == data
    assert calls["huf_anchors"] > 0, "anchor path never engaged"
    assert calls["huf_lits"] == 0, "qualifying literals decoded on host"


def test_foreign_mixed_with_rle_and_raw_blocks():
    """Foreign frame whose blocks mix huffman-literal and raw/short blocks:
    anchored blocks ride the kernel, the rest keep their host tiers."""
    rng = np.random.default_rng(9)
    parts = [_mk_text(140_000),
             rng.integers(0, 256, 2000, np.uint8).tobytes(),  # incompressible
             b"z" * 50_000]
    data = b"".join(parts)
    payload = zstd.ZstdCompressor(level=3).compress(data)
    out = dd.decode_payload_device(payload, len(data))
    assert out is not None
    assert np.asarray(out).tobytes() == data
