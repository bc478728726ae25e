"""Entropy stage: zstd frames (huffman-literals) must decode via libzstd."""

import numpy as np
import pytest

from stenos_tpu.entropy import encode_frame_host
from stenos_tpu.host import zstd as zstd_host


def _libzstd_ok():
    try:
        zstd_host.compress(b"x" * 100, 200, 1)
        return True
    except Exception:
        return False


pytestmark = pytest.mark.skipif(not _libzstd_ok(), reason="no libzstd")


def cases(rng):
    yield "skewed", rng.choice(
        256, 60_000, p=np.random.default_rng(1).dirichlet(np.ones(256) * .1))
    yield "gauss", rng.normal(128, 12, 150_000).clip(0, 255)
    yield "uniform", rng.integers(0, 256, 140_000)
    yield "text", np.frombuffer(b"entropy stage round trip " * 5000, np.uint8)
    yield "fewsyms", rng.integers(0, 5, 200_000)
    yield "same", np.full(5000, 42)
    yield "tiny", np.arange(20) % 7
    yield "empty", np.zeros(0)
    yield "block-crossing", rng.integers(0, 40, 150_000)


def test_frames_decode_with_libzstd(rng):
    for name, a in cases(rng):
        a = a.astype(np.uint8)
        frame = encode_frame_host(a)
        back = zstd_host.decompress(frame, len(a) + 16)
        assert back is not None and back == a.tobytes(), name


def test_compression_actually_happens(rng):
    a = rng.integers(0, 5, 200_000).astype(np.uint8)
    frame = encode_frame_host(a)
    assert len(frame) < len(a) // 2  # ~2.3 bits/symbol on 5-symbol data


def test_sequences_section(rng):
    """Run matches (offset-1 sequences, predefined FSE tables) compress
    plateau data far beyond entropy coding and stay libzstd-decodable."""
    a = np.repeat(rng.integers(0, 256, 3000),
                  rng.integers(5, 90, 3000)).astype(np.uint8)[:150_000]
    frame = encode_frame_host(a)
    back = zstd_host.decompress(frame, len(a) + 16)
    assert back == a.tobytes()
    assert len(frame) < len(a) // 8  # literals-only manages ~1.5x here


def test_runs_family_beats_libzstd(rng):
    """VERDICT r2 target: runs-family size within 2% of libzstd level 3.
    With repcode recoding + custom FSE tables the host encoder now BEATS
    libzstd on run-structured data; pin that so it never regresses."""
    import zstandard as zstd

    fams = [
        np.repeat(rng.integers(0, 8, 40_000).astype(np.uint8),
                  rng.integers(1, 60, 40_000)),
        np.repeat(rng.integers(0, 256, 8_000).astype(np.uint8),
                  rng.integers(20, 90, 8_000)),
        np.repeat(rng.integers(0, 40, 90_000).astype(np.uint8), 9),
    ]
    for a in fams:
        data = a.tobytes()
        f = encode_frame_host(a)
        z3 = zstd.ZstdCompressor(level=3).compress(data)
        assert len(f) <= len(z3) * 1.02, (len(f), len(z3))
        assert zstd_host.decompress(f, len(data) + 16) == data


def test_sequences_edges(rng):
    from stenos_tpu.entropy.sequences import encode_sequences
    from stenos_tpu.entropy.zstd_frame import raw_literals_section

    # exhaustive-ish ml sweep through every ML code bucket via raw frames
    for ml in (3, 34, 35, 42, 43, 58, 66, 98, 130, 131, 258, 259, 1027,
               40000, 70000):
        lits = rng.integers(1, 255, 8).astype(np.uint8)
        content = raw_literals_section(lits) + encode_sequences([(5, 4, ml)])
        n = 8 + ml
        f = (0xFD2FB528).to_bytes(4, "little") + bytes([0xA0])
        f += n.to_bytes(4, "little")
        f += (1 | (2 << 1) | (len(content) << 3)).to_bytes(3, "little")
        f += content
        want = (lits[:5].tobytes() + bytes([int(lits[4])]) * ml
                + lits[5:].tobytes())
        assert zstd_host.decompress(f, n + 16) == want, ml


def test_device_path_routes_runny_blocks(rng):
    from stenos_tpu.entropy.zstd_frame import encode_frame_device

    a = np.repeat(rng.integers(0, 256, 4000),
                  rng.integers(20, 90, 4000)).astype(np.uint8)[: 2 * 131072]
    frame = encode_frame_device(a)
    back = zstd_host.decompress(frame, len(a) + 16)
    assert back == a.tobytes()
    assert len(frame) < len(a) // 8


def test_general_matches_and_custom_fse(rng):
    """General-offset match finding + custom FSE sequence tables: frames
    must decode via libzstd and land near libzstd's own size (the
    reference's entropy stage, zstd_wrapper.h:59-90)."""
    from stenos_tpu.entropy.zstd_frame import encode_frame_host
    from stenos_tpu.host import zstd as zh

    words = [rng.bytes(int(rng.integers(3, 9))) for _ in range(200)]
    text = b" ".join(words[int(rng.integers(0, 200))] for _ in range(30000))
    data = np.frombuffer(text[:200000], np.uint8)
    f = encode_frame_host(data)
    assert zh.decompress(f, len(data) + 64) == data.tobytes()
    z = zh.compress(data.tobytes(), len(data) * 2 + 1024, 3)
    assert len(f) <= len(z) * 1.10, (len(f), len(z))


def test_match_finder_correctness(rng):
    from stenos_tpu.entropy.match import find_matches, greedy_parse

    data = np.frombuffer(
        b"abcdefgh" + rng.bytes(64) + b"XabcdefghY" + rng.bytes(32)
        + b"abcdefgh", np.uint8)
    pos, dist, ml = find_matches(data)
    assert len(pos)  # the repeated 8-byte word must be found
    for p, d, l in zip(pos, dist, ml):
        assert (data[p : p + l] == data[p - d : p - d + l]).all()

    r = greedy_parse(np.frombuffer(
        (b"0123456789abcdef" * 64 + rng.bytes(16)) * 8, np.uint8))
    assert r is not None
    seqs, lits = r
    # reconstruct and compare
    out = bytearray()
    li = 0
    lits_b = lits.tobytes()
    for ll, ofv, mlen in seqs:
        out += lits_b[li : li + ll]
        li += ll
        off = ofv - 3
        for _ in range(mlen):
            out.append(out[-off])
    out += lits_b[li:]


def test_sequences_channel_modes(rng):
    """RLE / Predefined / Compressed channel modes all decode."""
    from stenos_tpu.entropy.sequences import encode_sequences
    from stenos_tpu.entropy.zstd_frame import raw_literals_section
    from stenos_tpu.host import zstd as zh

    # constant ll/ml/offset -> RLE channels
    lits = rng.integers(0, 255, 10 * 8).astype(np.uint8)
    seqs = [(8, 4 + 3, 16)] * 9 + [(8, 4 + 3, 16)]
    # build the decoded content to know expected output
    out = bytearray()
    li = 0
    lb = lits.tobytes()
    for ll, ofv, mlen in seqs:
        out += lb[li : li + ll]
        li += ll
        off = ofv - 3
        for _ in range(mlen):
            out.append(out[-off])
    out += lb[li:]
    content = raw_literals_section(lits) + encode_sequences(seqs)
    frame = bytearray()
    frame += (0xFD2FB528).to_bytes(4, "little")
    frame += bytes([0xA0]) + len(out).to_bytes(4, "little")
    frame += (1 | (2 << 1) | (len(content) << 3)).to_bytes(3, "little")
    frame += content
    assert zh.decompress(bytes(frame), len(out) + 64) == bytes(out)
