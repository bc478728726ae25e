#!/usr/bin/env python
"""Device time of each XLA stage of the codec on the GPU, against the copy
rate a large jnp copy reaches in the same process.

    python benchs/kernel_decisions.py [--out results.json]

Stages: the record encode with decode index (512 MB of sorted int32), the
explicit- and derive-index decoders (the same 512 MB), and the device
Huffman histogram, encode and decode (64 MB). For each: compile + first
call seconds (set-up), the best wall time of three calls ending in
block_until_ready, and the device time per call from a jax.profiler trace
of three calls (benchs/trace_reduce.py: the union of kernel and device
copy intervals on the card's streams, over three). GB/s counts input bytes (decoded
bytes for the decoders); copy_share is that rate over the copy's. Every
output is checked byte for byte once.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

import jax
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from trace_reduce import device_times  # noqa: E402

MB = 1 << 20
SB = 131072


def measure(name, fn, nbytes):
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    setup = time.perf_counter() - t0
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        walls.append(time.perf_counter() - t0)
    with tempfile.TemporaryDirectory() as d:
        jax.profiler.start_trace(d)
        for _ in range(3):
            jax.block_until_ready(fn())
        jax.profiler.stop_trace()
        tr = device_times(d)
    dev_ns = tr["busy_ns"] / 3  # the three calls run one after another
    top = sorted(tr["kernels"].items(), key=lambda kv: -kv[1])[:5]
    row = {
        "stage": name, "input_bytes": nbytes,
        "setup_s": round(setup, 3), "wall_best_s": round(min(walls), 6),
        "device_ns_per_call": int(dev_ns),
        "device_gbps": round(nbytes / dev_ns, 3) if dev_ns else None,
        "wall_gbps": round(nbytes / min(walls) / 1e9, 3),
        "top_kernels_ns_per_call": {k[:80]: int(v / 3) for k, v in top},
        "busy_share_of_trace_window": round(
            tr["busy_ns"] / tr["window_ns"], 4) if tr["window_ns"] else None,
    }
    if not tr["kernels"]:  # name the device lines the trace did have
        row["trace_lines"] = tr["lines"]
    print(json.dumps(row), flush=True)
    return row


def main():
    from stenos_tpu.engine_jax import (_bucket125, block_records,
                                       decode_slabs_derive_jit,
                                       decode_slabs_jit, encode_records_jit)
    from stenos_tpu.entropy.huff_device import (decode_streams_device,
                                                decode_tables,
                                                encode_streams_device,
                                                histogram_device)
    from stenos_tpu.entropy.huffman import (build_ctables_batch,
                                            code_lengths_batch)
    from stenos_tpu.native import lib as native
    from stenos_tpu.utils.cache import use_compile_cache

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the rows as JSON here")
    args = ap.parse_args()
    d0 = jax.devices()[0]
    if d0.platform != "gpu":
        sys.exit(f"measures the GPU; JAX's device is {d0.platform}")
    use_compile_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"{d0.device_kind} / {smi}", flush=True)
    rows = []

    big = jnp.zeros(1 << 30, jnp.uint8)
    copy = jax.jit(lambda a: a + jnp.uint8(1))
    rows.append(measure("jnp copy (a + 1), 1 GiB", lambda: copy(big),
                        1 << 30))
    del big
    copy_gbps = rows[0]["device_gbps"]

    rng = np.random.default_rng(42)
    n = 512 * MB
    raw = np.cumsum(rng.integers(0, 16, n // 4, dtype=np.int32),
                    dtype=np.int32).view(np.uint8)
    x = jax.device_put(raw.reshape(-1, SB))
    rows.append(measure("encode_records_jit with_index, 512 MB bpp 4",
                        lambda: encode_records_jit(x, 4, 2, with_index=True),
                        n))
    recs, totals, _, _, index = encode_records_jit(x, 4, 2, with_index=True)
    totals = np.asarray(totals)
    rb = _bucket125(int(totals.max()) + 512)
    rb_rows = recs[:, :rb]
    out = decode_slabs_derive_jit(rb_rows, index, 4, 128)
    assert np.asarray(out).tobytes() == raw.tobytes(), "derive decode"
    rows.append(measure("decode_slabs_derive_jit, 512 MB bpp 4",
                        lambda: decode_slabs_derive_jit(rb_rows, index, 4,
                                                        128), n))
    recs_h = np.asarray(recs)
    frame = b"".join([bytes([0]) + n.to_bytes(7, "little")]
                     + [recs_h[i, : totals[i]].tobytes()
                        for i in range(len(totals))])
    del recs, rb_rows, index, out, x
    offs, csizes = block_records(frame, 8, len(totals))
    vb, po, rt, _ = native.parse_rows_batch(frame, 4, SB, offs, csizes, rb)
    args_d = [jax.device_put(a) for a in (vb, po, rt)]
    out = decode_slabs_jit(*args_d, 4, 128)
    assert np.asarray(out).tobytes() == raw.tobytes(), "explicit decode"
    del out
    rows.append(measure("decode_slabs_jit (explicit index), 512 MB bpp 4",
                        lambda: decode_slabs_jit(*args_d, 4, 128), n))
    del args_d

    e = 64 * MB
    noisy = rng.integers(0, 64, e).astype(np.uint8)
    noisy[rng.integers(0, e, e // 16)] = rng.integers(0, 256, e // 16)
    blocks = jax.device_put(noisy.reshape(-1, 131072))
    rows.append(measure("histogram_device, 64 MB", lambda:
                        histogram_device(blocks), e))
    hist = np.asarray(histogram_device(blocks))
    lens = code_lengths_batch(hist)
    luts = np.repeat(build_ctables_batch(lens).astype(np.int32)
                     | (lens.astype(np.int32) << 11), 4, axis=0)
    streams = jax.device_put(noisy.reshape(-1, 32768))
    luts_d = jax.device_put(luts)
    rows.append(measure("encode_streams_device, 64 MB", lambda:
                        encode_streams_device(streams, luts_d), e))
    words, sizes, anchors = encode_streams_device(streams, luts_d)
    words = np.ascontiguousarray(np.asarray(words)).view(np.uint8)
    sizes = np.asarray(sizes)
    width = -(-int(sizes.max()) // 128) * 128
    sb = jax.device_put(np.ascontiguousarray(words[:, :width]))
    tabs = jax.device_put(np.repeat(
        np.stack([decode_tables(lens[b])[0] for b in range(len(lens))]),
        4, axis=0))
    out = decode_streams_device(sb, anchors, tabs)
    assert np.asarray(out).tobytes() == noisy.tobytes(), "huffman decode"
    rows.append(measure("decode_streams_device, 64 MB", lambda:
                        decode_streams_device(sb, anchors, tabs), e))

    for r in rows:
        r["copy_share"] = (round(r["device_gbps"] / copy_gbps, 4)
                           if r["device_gbps"] else None)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device_kind": d0.device_kind, "nvidia_smi": smi,
                       "rows": rows}, f, indent=1)
    for r in rows:
        print(f"{r['stage']:52s} device {r['device_ns_per_call'] / 1e6:9.3f}"
              f" ms  {r['device_gbps']} GB/s  copy share {r['copy_share']}"
              f"  set-up {r['setup_s']} s")


if __name__ == "__main__":
    main()
