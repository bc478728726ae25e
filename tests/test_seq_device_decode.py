"""Device decode of sequence-bearing zstd payloads (tier 2 of
entropy/device_decode.py): host O(nseq) index work + device bulk match
reconstruction. Reference behavior matched: stenos.cpp:694-753 decodes
every method-2/3/4/5 payload through full zstd (zstd_wrapper.h:59-90) —
here the bulk bytes stay on device.

Runs on the CPU backend (conftest forces JAX_PLATFORMS=cpu, 8 virtual
devices); run_programs is pure XLA, the same program the GPU runs.
"""

import os

import numpy as np
import pytest
import zstandard as zstd

from stenos_tpu.entropy.device_decode import decode_payload_device

FULL = bool(os.environ.get("STENOS_FULL_GRID"))


def _check(payload: bytes, data: bytes):
    out = decode_payload_device(payload, len(data))
    assert out is not None, "fell back to host"
    assert bytes(np.asarray(out).tobytes()) == data


def _families(rng):
    n = 260_000 if FULL else 80_000
    m = 9000 if FULL else 4000
    return {
        "text": b"the quick brown fox jumps over the lazy dog " * m,
        "runs": np.repeat(rng.integers(0, 8, m, np.uint8),
                          rng.integers(1, 60, m)).tobytes(),
        "ts": np.cumsum(rng.integers(-3, 4, n)).astype(np.int16)
              .tobytes(),
        "short": b"abcabcabcXY",
    }


@pytest.mark.parametrize("level", [1, 3, 9] if FULL else [1, 3])
def test_libzstd_sequence_frames(level):
    rng = np.random.default_rng(5)
    for name, data in _families(rng).items():
        c = zstd.ZstdCompressor(level=level).compress(data)
        _check(c, data)


def test_raw_block_between_sequence_blocks():
    """A libzstd frame whose middle block is incompressible (Raw_Block)
    surrounded by sequence-bearing blocks: exercises the gapless layout's
    direct-piece handling (a preceding seq op's W-overrun must not corrupt
    the raw piece, and following blocks' matches may read into it)."""
    rng = np.random.default_rng(11)
    blk = 131072
    # period 3: the compressed block's final copy op is NOT W-aligned, so
    # its overrun reaches into the raw block's bytes and must be repaired
    data = ((b"abc" * blk)[:blk]
            + rng.integers(0, 256, blk, np.uint8).tobytes()
            + (b"xyz" * blk)[:blk])
    c = zstd.ZstdCompressor(level=3).compress(data)
    from stenos_tpu.entropy.zstd_parse import parse_frame
    parsed = parse_frame(c)
    assert parsed is not None
    btypes = [b.btype for b in parsed[1]]
    assert 0 in btypes, f"expected a raw block, got {btypes}"
    _check(c, data)


def test_rle_and_short_blocks():
    blk = 131072
    data = b"\x00" * blk + b"hello world, hello world, hello" + b"\x07" * 50
    c = zstd.ZstdCompressor(level=3).compress(data)
    _check(c, data)


def test_own_encoder_runny_frame():
    """encode_frame_host emits sequence blocks for runny data; they must
    decode through the device tier, bit-exact."""
    from stenos_tpu.entropy.zstd_frame import encode_frame_host

    rng = np.random.default_rng(3)
    data = np.repeat(rng.integers(0, 40, 40_000, np.uint8), 9)[:300_000]
    f = encode_frame_host(data)
    _check(bytes(f), data.tobytes())


def test_mixed_frame_device_literals():
    """A device-encoded MIXED frame (anchored literals-only blocks around a
    runny sequence block): tier 2 must decode the anchored blocks' Huffman
    streams on the device (devlit patches) — not fall back to host literal
    decode — and stay bit-exact. Reference behavior: stenos.cpp:694-753
    (every entropy payload decodes through full zstd)."""
    import stenos_tpu.entropy.device_decode as dd
    from stenos_tpu.entropy.sidecar import split_sidecar
    from stenos_tpu.entropy.zstd_frame import encode_frame_device

    rng = np.random.default_rng(7)
    blk = 131072
    lit0 = rng.integers(0, 40, blk, np.uint8)
    runny = np.repeat(rng.integers(0, 40, blk, np.uint8),
                      9)[:blk].astype(np.uint8)
    lit1 = rng.integers(0, 40, blk, np.uint8)
    data = np.concatenate([lit0, runny, lit1]).tobytes()
    # STENOS_SEQ_ANCHORS=0 pins the runny block anchor-LESS so the frame
    # stays mixed (the seq-anchor path has its own test below)
    os.environ["STENOS_SEQ_ANCHORS"] = "0"
    try:
        f = bytes(encode_frame_device(np.frombuffer(data, np.uint8)))
    finally:
        os.environ.pop("STENOS_SEQ_ANCHORS", None)
    _, entries = split_sidecar(f)
    assert entries is not None
    kinds = [e is not None for e in entries]
    assert True in kinds and False in kinds, f"not a mixed frame: {kinds}"

    calls = []
    orig = dd._batch_decode_streams

    def spy(payload, jobs):
        calls.append(len(jobs))
        return orig(payload, jobs)

    dd._batch_decode_streams = spy
    try:
        _check(f, data)
    finally:
        dd._batch_decode_streams = orig
    # every block with 4-stream tree-bearing Huffman literals rides the
    # kernel: the sidecar-anchored ones AND (since the foreign-anchor scan,
    # stn_huf_anchors) the anchor-less ones — count them from the frame
    from stenos_tpu.entropy.zstd_parse import _parse_sections, parse_frame

    frame_end, _ = split_sidecar(f)
    _, blocks, _ = parse_frame(f, frame_end)
    nqual = 0
    for spec in blocks:
        _parse_sections(f, spec)
        lit = spec.lit
        if (lit is not None and lit.kind == "huf" and lit.four
                and not lit.treeless and lit.regenerated >= 64):
            nqual += 1
    assert nqual >= kinds.count(True)
    assert calls and calls[0] == nqual


def test_seq_block_device_literals():
    """Sequence-bearing blocks from OUR device encoder carry literal
    anchors in the sidecar (zstd_frame._block_anchor_entry): tier 2 must
    decode their Huffman literals on the device (patched into the staged
    buffer on-device) — host work is the O(nseq) FSE index only — and the
    enlarged sidecar must stay invisible to standard decoders."""
    import stenos_tpu.entropy.device_decode as dd
    from stenos_tpu.entropy.sidecar import split_sidecar
    from stenos_tpu.entropy.zstd_frame import encode_frame_device
    from stenos_tpu.entropy.zstd_parse import parse_frame

    rng = np.random.default_rng(13)
    # records family: repeated 64-byte rows (match-rich) with skewed
    # symbol distribution (Huffman-codable literals)
    pool = rng.integers(0, 40, (400, 64), np.uint8)
    idx = rng.integers(0, 400, 4096 + 12)
    data = pool[idx].reshape(-1).tobytes()  # 2 full blocks + 768 B tail
    f = bytes(encode_frame_device(np.frombuffer(data, np.uint8)))
    fe, entries = split_sidecar(f)
    assert entries is not None
    _, blocks, _ = parse_frame(f, fe)
    seq_anch = [i for i, (b, e) in enumerate(zip(blocks, entries))
                if e is not None and b.btype == 2
                and not (b.seq_len == 1 and f[b.seq_off] == 0)]
    assert seq_anch, (
        f"no anchored sequence block: "
        f"{[(b.btype, e is not None) for b, e in zip(blocks, entries)]}")

    calls = []
    orig = dd._batch_decode_streams

    def spy(payload, jobs):
        calls.append(len(jobs))
        return orig(payload, jobs)

    dd._batch_decode_streams = spy
    try:
        _check(f, data)
    finally:
        dd._batch_decode_streams = orig
    assert calls and calls[0] >= len(seq_anch)
    assert zstd.ZstdDecompressor().decompress(
        f, max_output_size=len(data)) == data


def test_full_frame_path_entropy_decompress():
    """The frame._entropy_decompress ladder takes the device tier for a
    sequence-bearing payload (no sidecar) when an engine is present."""
    from stenos_tpu import frame as frame_mod

    class _Eng:  # truthy placeholder: engine presence enables the tier
        pass

    data = (b"the quick brown fox jumps over the lazy dog " * 6000)[:262144]
    c = zstd.ZstdCompressor(level=3).compress(data)
    r = frame_mod._entropy_decompress(c, len(data), _Eng())
    assert r is not None and bytes(np.asarray(r).tobytes()) == data
