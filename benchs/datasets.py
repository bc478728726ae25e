"""Benchmark corpus: realistic stand-ins for the stenos_dataset families.

The reference benches on stenos_dataset (JS text, uint16 images,
float3/float4 meshes, double time series — reference
benchs/bench_all.cpp:302-313). That corpus can't be fetched in this
environment (zero egress), so each family here is built to MATCH ITS
STATISTICS rather than being a toy tiling:

- text:   a frozen 600 KB excerpt of REAL code text (this repo's own
          sources, checked in at benchs/data/code_text.txt) — same class
          as the reference's JS corpus: ~6 bits/byte order-0 entropy,
          dense LZ matches at mixed offsets, long identifier repeats.
- image:  band-limited smooth field (small random grid bilinearly
          upsampled 16x) + shot noise, 12-bit range in uint16 — the
          low-gradient + sensor-noise structure of real u16 images.
- mesh:   float32 xyz (and xyzw) vertices of a noise-displaced sphere
          grid — clustered exponents, correlated mantissa high bytes,
          exactly the byte-plane structure mesh compressors exploit.
- ts:     double random walk + diurnal seasonality + regime jumps —
          smooth high-byte planes, noisy low ones.
- records: fixed 64-byte rows drawn from a pool of 400 with a skewed
          byte alphabet — match-rich rows whose literals are still
          Huffman-codable (the zstd sequences path).

Every family is deterministic (fixed seed / frozen file): ratios are
comparable across rounds.
"""

import os

import numpy as np

_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def text_u8(n: int) -> bytes:
    with open(os.path.join(_DATA, "code_text.txt"), "rb") as f:
        base = f.read()
    reps = -(-n // len(base))
    return (base * reps)[:n]


def image_u16(n: int, seed: int = 7) -> bytes:
    rng = np.random.default_rng(seed)
    side = int((n // 2) ** 0.5)
    small = side // 16 + 2
    grid = rng.normal(0, 1, (small, small))
    # bilinear upsample x16: band-limited smooth field
    up = np.repeat(np.repeat(grid, 16, 0), 16, 1)[: side, : side]
    k = np.ones(17) / 17.0
    for ax in (0, 1):
        up = np.apply_along_axis(
            lambda r: np.convolve(r, k, mode="same"), ax, up)
    lo, hi = up.min(), up.max()
    img = (up - lo) / max(hi - lo, 1e-9) * 3000 + 200  # 12-bit-ish range
    img = img + rng.poisson(8, img.shape)              # shot noise
    return img.astype("<u2").tobytes()[: (n // 2) * 2]


def _sphere_mesh(npts: int, comps: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    side = int(npts ** 0.5) + 1
    u = np.linspace(0, np.pi, side)
    v = np.linspace(0, 2 * np.pi, side)
    uu, vv = np.meshgrid(u, v)
    # fbm-ish displacement: 3 octaves of smoothed noise
    disp = np.zeros_like(uu)
    for o in range(3):
        g = rng.normal(0, 0.5 ** o, (side // (8 >> o) + 2,) * 2)
        g = np.repeat(np.repeat(g, 8 >> o, 0), 8 >> o, 1)[: side, : side]
        disp += g
    r = 1.0 + 0.1 * disp
    pts = np.stack([r * np.sin(uu) * np.cos(vv),
                    r * np.sin(uu) * np.sin(vv),
                    r * np.cos(uu)], axis=-1).reshape(-1, 3)
    if comps == 4:
        w = np.linalg.norm(pts, axis=1, keepdims=True)
        pts = np.concatenate([pts, w], axis=1)
    return pts[:npts].astype("<f4")


def mesh_f3(n: int, seed: int = 11) -> bytes:
    return _sphere_mesh(n // 12, 3, seed).tobytes()[: (n // 12) * 12]


def mesh_f4(n: int, seed: int = 13) -> bytes:
    return _sphere_mesh(n // 16, 4, seed).tobytes()[: (n // 16) * 16]


def ts_f64(n: int, seed: int = 17) -> bytes:
    rng = np.random.default_rng(seed)
    nd = n // 8
    t = np.arange(nd)
    walk = np.cumsum(rng.normal(0, 1e-3, nd))
    season = 0.5 * np.sin(2 * np.pi * t / 86400) \
        + 0.05 * np.sin(2 * np.pi * t / 3600)
    jumps = np.cumsum(rng.random(nd) < 1e-5) * 0.8
    return (100.0 + walk + season + jumps).astype("<f8").tobytes()


def records_u8(n: int, seed: int = 13) -> bytes:
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 40, (400, 64), np.uint8)
    idx = rng.integers(0, 400, n // 64 + 1)
    return pool[idx].reshape(-1)[:n].tobytes()


def families(n: int):
    """[(name, bytesoftype, bytes)] — the corpus bench_all sweeps."""
    return [
        ("text u8", 1, text_u8(n)),
        ("image u16", 2, image_u16(n)),
        ("mesh float3", 12, mesh_f3(n)),
        ("mesh float4", 16, mesh_f4(n)),
        ("timeseries f64", 8, ts_f64(n)),
    ]
