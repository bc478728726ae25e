#!/usr/bin/env python
"""stenos-tpu benchmark on the GPU. Prints progressive JSON lines; the LAST
line is the most complete snapshot (parse the last JSON-parseable stdout
line).

Headline: block-codec encode GB/s on the BASELINE config (512 MB of sorted
int32, bpp 4, level-1/2 block path) with the data device-resident — the
counterpart of the reference's RAM-to-RAM single-thread numbers (~2 GB/s
encode / ~3 GB/s decode, README.md:12 of the reference). Extra fields:
decode, end-to-end decode from host bytes, the device round trip, and the
entropy stage.

Every timed call ends in jax.block_until_ready and its output is checked
byte for byte once. Each section's exception is recorded in
extra.sections, and a snapshot line is flushed after every section. The
run fails on a machine whose JAX device is not a GPU: CPU times are never
printed under device metric names.

    python bench.py    # STENOS_BENCH_MB (default 512), STENOS_BENCH_REPS (3)
"""

import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

import jax

from stenos_tpu.utils.cache import use_compile_cache

MB = int(os.environ.get("STENOS_BENCH_MB", "512"))
REPS = int(os.environ.get("STENOS_BENCH_REPS", "3"))
PARITY_MB = 16
BPP = 4
SB = 131072

T0 = time.perf_counter()


def best_time(fn):
    """Minimum wall seconds over REPS calls of fn (after one warm call);
    fn's result is waited for with block_until_ready."""
    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(REPS):
        t = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t)
    return best


class Bench:
    def __init__(self):
        d = jax.devices()[0]
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
        self.extra = {
            "input_mb": MB,
            "platform": d.platform,
            "device_kind": d.device_kind,
            "device_count": len(jax.devices()),
            "nvidia_smi_name_power_limit": smi,
            "timing": "min of REPS calls ending in block_until_ready",
        }
        self.sections = {}
        self.secs = {}
        self.enc_gbps = 0.0

    def emit(self):
        self.extra["sections"] = self.sections
        self.extra["section_secs"] = {k: round(v, 1)
                                      for k, v in self.secs.items()}
        self.extra["total_secs"] = round(time.perf_counter() - T0, 1)
        print(json.dumps({
            "metric": "block codec encode GB/s (sorted int32, "
                      "device-resident, bit-exact stenos records)",
            "value": round(self.enc_gbps, 3),
            "unit": "GB/s",
            "vs_baseline": round(self.enc_gbps / 2.0, 3),
            "extra": self.extra,
        }), flush=True)

    def run(self, name, fn):
        t = time.perf_counter()
        try:
            fn(self)
            self.sections[name] = "ok"
        except Exception as e:
            tb = traceback.format_exc(limit=3).replace("\n", " | ")
            self.sections[name] = f"error: {type(e).__name__}: {e} [{tb}]"[:500]
        self.secs[name] = time.perf_counter() - t
        self.emit()


def sec_encode(b):
    import stenos_tpu as st
    from stenos_tpu.engine_jax import encode_records_jit

    rng = np.random.default_rng(42)
    nbytes = MB * 1024 * 1024
    n_sb = nbytes // SB
    raw = np.cumsum(rng.integers(0, 16, nbytes // BPP, dtype=np.int32),
                    dtype=np.int32).view(np.uint8)
    batch_dev = jax.device_put(raw.reshape(n_sb, SB))

    t_enc = best_time(lambda: encode_records_jit(batch_dev, BPP, 2))
    b.enc_gbps = nbytes / t_enc / 1e9
    rows, sizes, _, _ = encode_records_jit(batch_dev, BPP, 2)
    sizes_h = np.asarray(sizes)
    b.extra["compression_ratio"] = round(nbytes / (8 + int(sizes_h.sum())), 3)
    b.rng, b.nbytes, b.n_sb, b.raw = rng, nbytes, n_sb, raw
    b.batch_dev, b.rows, b.sizes_h = batch_dev, rows, sizes_h
    b.st = st


def sec_parity(b):
    """The first PARITY_MB of device records == the host path's frame."""
    pbytes = PARITY_MB * 1024 * 1024
    host_frame = b.st.compress(b.raw[:pbytes], BPP, 1)
    rows_h = np.asarray(b.rows[: pbytes // SB])
    pframe = bytearray(host_frame[:8])
    for i in range(pbytes // SB):
        pframe += bytes(rows_h[i][: b.sizes_h[i]])
    b.extra["frame_equals_host_path_bitexact"] = bytes(pframe) == host_frame


def sec_decode(b):
    from stenos_tpu.engine_jax import (_bucket125, block_records,
                                       decode_slabs_jit)
    from stenos_tpu.native import lib as native

    nb = SB // (256 * BPP)
    rows_all = np.asarray(b.rows)
    frame = bytearray(bytes([0]) + b.nbytes.to_bytes(7, "little"))
    for i in range(b.n_sb):
        frame += bytes(rows_all[i][: int(b.sizes_h[i])])
    frame = bytes(frame)
    offs, csizes = block_records(frame, 8, b.n_sb)
    row_bytes = _bucket125(max(csizes) + 512)

    def parse():
        return native.parse_rows_batch(frame, BPP, SB, offs, csizes,
                                       row_bytes)[:3]

    parse()
    t0 = time.perf_counter()
    pr = parse()
    b.extra["host_parse_gbps"] = round(
        b.nbytes / (time.perf_counter() - t0) / 1e9, 3)
    args = [jax.device_put(x) for x in pr]
    out = decode_slabs_jit(*args, BPP, nb)
    b.extra["decode_roundtrip_ok"] = (
        np.asarray(out).tobytes() == b.raw.tobytes())
    t_dec = best_time(lambda: decode_slabs_jit(*args, BPP, nb))
    b.extra["decode_device_gbps"] = round(b.nbytes / t_dec / 1e9, 3)

    t_e2e = best_time(lambda: b.st.decompress(frame, BPP, engine="auto"))
    b.extra["decode_e2e_host_bytes_gbps"] = round(b.nbytes / t_e2e / 1e9, 3)
    t_host = best_time(lambda: b.st.decompress(frame, BPP))
    b.extra["decode_host_path_gbps"] = round(b.nbytes / t_host / 1e9, 3)


def sec_roundtrip(b):
    from stenos_tpu.engine_jax import roundtrip_device

    rtb = min(b.nbytes, 256 * 1024 * 1024)
    rt_in = b.batch_dev[: rtb // SB]
    w, _, _ = roundtrip_device(rt_in, BPP, 2)
    b.extra["device_roundtrip_ok"] = (
        np.asarray(w).tobytes() == b.raw[:rtb].tobytes())
    t_rt = best_time(lambda: roundtrip_device(rt_in, BPP, 2))
    b.extra["device_roundtrip_gbps"] = round(rtb / t_rt / 1e9, 3)


def sec_entropy_encode(b):
    from stenos_tpu.entropy.huff_device import (encode_streams_device,
                                                histogram_device)
    from stenos_tpu.entropy.huffman import (build_ctables_batch,
                                            code_lengths_batch)
    from stenos_tpu.entropy.zstd_frame import encode_frame_device
    from stenos_tpu.host import zstd as zstd_host

    ebytes = min(b.nbytes, 64 * 1024 * 1024)
    nblk = ebytes // 131072
    noisy = np.cumsum(
        b.rng.normal(0, 300, ebytes // 4)).astype("<i4").view(np.uint8)
    blocks = jax.device_put(noisy.reshape(nblk, 131072))
    hist = np.asarray(histogram_device(blocks))
    b.extra["entropy_hist_ok"] = bool(
        (hist[0] == np.bincount(noisy[:131072], minlength=256)).all())
    t_h = best_time(lambda: histogram_device(blocks))
    b.extra["entropy_hist_gbps"] = round(ebytes / t_h / 1e9, 3)

    lens_all = code_lengths_batch(hist)
    codes_all = build_ctables_batch(lens_all)
    luts = jax.device_put(np.repeat(
        codes_all.astype(np.int32) | (lens_all.astype(np.int32) << 11),
        4, axis=0))
    streams = jax.device_put(noisy.reshape(nblk * 4, 32768))
    t_e = best_time(lambda: encode_streams_device(streams, luts))
    b.extra["entropy_huffman_encode_gbps"] = round(ebytes / t_e / 1e9, 3)

    n = 2 * 131072 + 999
    fsmall = encode_frame_device(noisy[:n])
    b.extra["entropy_frames_decode_via_libzstd"] = (
        zstd_host.decompress(fsmall, n + 16) == noisy[:n].tobytes())


def sec_entropy_decode(b):
    from stenos_tpu.entropy.device_decode import _parse_device_block
    from stenos_tpu.entropy.huff_device import (decode_streams_device,
                                                decode_tables)
    from stenos_tpu.entropy.sidecar import split_sidecar
    from stenos_tpu.entropy.zstd_frame import encode_frame_device
    from stenos_tpu.entropy.zstd_parse import parse_frame

    ebytes = min(b.nbytes, 128 * 1024 * 1024)
    nblk = ebytes // 131072
    # iid skewed bytes: Huffman-compressible (~6 bits/sym) but match-free,
    # so every block stays literals-only and the metric times the anchored
    # decode alone
    noisy = b.rng.integers(0, 64, ebytes).astype(np.uint8)
    noisy[b.rng.integers(0, ebytes, ebytes // 16)] = b.rng.integers(
        0, 256, ebytes // 16)
    fbig = encode_frame_device(noisy)
    frame_end, entries = split_sidecar(fbig)
    _, blocks, _ = parse_frame(fbig, frame_end)
    spans, anch, tabs, border = [], [], [], []
    for bi, (spec, ent) in enumerate(zip(blocks, entries)):
        pb = None if ent is None else _parse_device_block(
            fbig, spec.start, spec.size)
        if pb is None:
            continue
        border.append(bi)
        tab = decode_tables(ent[0])[0]
        for s, span in enumerate(pb[1]):
            spans.append(span)
            anch.append(ent[1][s])
            tabs.append(tab)
    eb = -(-max(ln for _, ln in spans) // 128) * 128
    sarr = np.zeros((len(spans), eb), np.uint8)
    pv = np.frombuffer(fbig, np.uint8)
    for i, (off, ln) in enumerate(spans):
        sarr[i, :ln] = pv[off : off + ln]
    args = [jax.device_put(x) for x in
            (sarr, np.stack(anch).astype(np.int32), np.stack(tabs))]
    want = noisy.reshape(nblk, 131072)[border]
    got = np.asarray(decode_streams_device(*args)).reshape(-1, 131072)
    b.extra["entropy_decode_ok"] = got.tobytes() == want.tobytes()
    t_d = best_time(lambda: decode_streams_device(*args))
    b.extra["entropy_decode_gbps"] = round(
        len(border) * 131072 / t_d / 1e9, 3)


def sec_sequences(b):
    from stenos_tpu.entropy.zstd_frame import encode_frame_device
    from stenos_tpu.host import zstd as zstd_host

    sbytes = min(b.nbytes, 16 * 1024 * 1024)
    rec = b.rng.integers(0, 256, 64).astype(np.uint8)
    md = np.tile(rec, sbytes // 64)
    md[b.rng.integers(0, sbytes, sbytes // 64)] = b.rng.integers(
        0, 256, sbytes // 64)
    encode_frame_device(md[: 4 * 131072], sidecar=False)  # warm compiles
    fseq = encode_frame_device(md, sidecar=False)
    t0 = time.perf_counter()
    encode_frame_device(md, sidecar=False)
    b.extra["sequences_encode_mbps"] = round(
        sbytes / (time.perf_counter() - t0) / 1e6, 1)
    b.extra["sequences_encode_ok"] = (
        zstd_host.decompress(fseq, sbytes) == md.tobytes())
    # stenos level 2 = zstd level 3 (zstd_wrapper.h:49-56)
    zs = len(zstd_host.compress(md.tobytes(), sbytes + 4096, 2))
    b.extra["sequences_size_vs_libzstd3"] = round(len(fseq) / zs, 3)


def main():
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX's device is "
                 f"{jax.devices()[0].platform}")
    use_compile_cache()
    b = Bench()
    for name, fn in (("encode", sec_encode), ("parity", sec_parity),
                     ("decode", sec_decode), ("roundtrip", sec_roundtrip),
                     ("entropy_encode", sec_entropy_encode),
                     ("entropy_decode", sec_entropy_decode),
                     ("sequences", sec_sequences)):
        b.run(name, fn)


if __name__ == "__main__":
    main()
