#!/usr/bin/env python
"""Smoke run of stenos-tpu on the GPU, through the public entry points.

    python chip_smoke.py          # one GPU: phases 1-6 below
    python chip_smoke.py --four   # four GPUs: the sharded frame path only

One card: 512 MB of sorted int32 (the BASELINE configuration, bpp 4) goes
through st.compress / st.decompress, the device-resident frame, every
element width, DeviceCompressedArray, the device entropy stage and the
time-limited mode. Four cards: 2 GB, 512 MB per card, through the sharded
frame API. Every device result is compared byte for byte (tolerance 0)
with the host path (native C++ + libzstd) or with the single-card path.

The script fails — non-zero exit, no result line — when JAX's device is
not a GPU, when the native library or libzstd is missing, or when any
phase fails. Times printed are smoke timings: one cold run, compilation
included, not measurements. The last stdout line is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
MB = 1 << 20
SB = 131072          # level-1/2 superblock at bpp 4
HEADLINE = 512 * MB  # per card
PREFIX = 64 * MB     # host-path comparison slice (the host encoder runs
                     # at a few MB/s: the full 512 MB would take minutes)


def sorted_int32(nbytes: int, seed: int) -> np.ndarray:
    """Sorted int32 from a seed, as bytes: a random walk with gaps 0..15."""
    rng = np.random.default_rng(seed)
    steps = rng.integers(0, 16, nbytes // 4, dtype=np.int32)
    return np.cumsum(steps, dtype=np.int32).view(np.uint8)


def peak_bytes(devices) -> int:
    return max(d.memory_stats()["peak_bytes_in_use"] for d in devices)


def phase(name, devices):
    def wrap(fn):
        t0 = time.perf_counter()
        fn()
        print(f"[smoke timing] {name}: {time.perf_counter() - t0:.1f} s "
              f"wall, peak device bytes {peak_bytes(devices)}", flush=True)
        return fn
    return wrap


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def environment(n_cards: int):
    import jax

    from stenos_tpu.utils.cache import use_compile_cache

    cache = use_compile_cache()
    devs = jax.devices()
    d0 = devs[0]
    print(f"platform {d0.platform}, device_kind {d0.device_kind}, "
          f"count {len(devs)}", flush=True)
    if d0.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's device is {d0.platform}")
    if len(devs) < n_cards:
        raise SystemExit(f"needs {n_cards} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"nvidia-smi: {smi}", flush=True)
    print(f"jax {jax.__version__}, compile cache {cache}", flush=True)
    from stenos_tpu.host import zstd as zstd_host
    from stenos_tpu.native import lib

    probe = zstd_host.compress(b"stenos" * 100, 4096, 1)
    check(isinstance(probe, bytes) and zstd_host.decompress(probe, 600)
          == b"stenos" * 100, "libzstd round trip")
    print(f"native library {lib._lib._name}, libzstd ok", flush=True)
    return devs[:n_cards]


def one_card(devs):
    import jax

    import stenos_tpu as st
    from stenos_tpu import frame as fr
    from stenos_tpu.engine_jax import JaxEngine, compress_frame_device_jit

    data = sorted_int32(HEADLINE, seed=42)
    prefix = data[:PREFIX]
    frames = {}

    @phase("1 headline st.compress/st.decompress 512 MB", devs)
    def _():
        check(isinstance(st.default_engine(), JaxEngine),
              "engine='auto' did not resolve to JaxEngine")
        for level in (1, 2):
            f = st.compress(data, 4, level, engine="auto")
            host = st.compress(prefix, 4, level)
            dev = st.compress(prefix, 4, level, engine="auto")
            check(dev == host, f"level {level}: 64 MB prefix frame differs "
                  "from the host path")
            # the superblock records of the prefix open the full frame
            check(f[8 : len(dev)] == dev[8:], f"level {level}: full frame "
                  "does not start with the prefix's records")
            back = st.decompress(f, 4, engine="auto")
            check(back.tobytes() == data.tobytes(),
                  f"level {level}: device decode differs from the input")
            frames[level] = f
            frames[f"host{level}"] = host
            print(f"  level {level}: ratio {len(data) / len(f):.4f}",
                  flush=True)

    @phase("2 device-resident frame 512 MB", devs)
    def _():
        x = jax.device_put(data.reshape(-1, SB), devs[0])
        f, n = compress_frame_device_jit(x, 4, 1)
        check(np.asarray(f)[: int(n)].tobytes() == frames[1],
              "compress_frame_device_jit differs from the level-1 frame")

    @phase("3 all widths: bpp 1-16 x 5 generators x levels 1, 2", devs)
    def _():
        # per width, the five generators' ~1 MB pieces (8 superblocks
        # each, so no superblock mixes two generators) and a short tail go
        # through one frame; widths run in threads so their compiles
        # overlap
        sys.path.insert(0, os.path.join(ROOT, "tests"))
        from _gen import gen_elements

        from stenos_tpu.constants import super_block_size

        def width(bpp):
            eng = JaxEngine()
            rng = np.random.default_rng(bpp)
            sb = super_block_size(256 * bpp)
            gens = ("sorted", "random", "same", "rle", "smallrange")
            raw = b"".join(gen_elements(rng, bpp, 8 * sb // bpp, kind)
                           for kind in gens)
            raw += gen_elements(rng, bpp, 777, "sorted")
            for level in (1, 2):
                dev = st.compress(raw, bpp, level, engine=eng)
                check(dev == st.compress(raw, bpp, level),
                      f"bpp {bpp} level {level}: device frame differs "
                      "from the host frame")
                back = st.decompress(dev, bpp, engine=eng)
                check(back.tobytes() == raw,
                      f"bpp {bpp} level {level}: decode differs")

        with ThreadPoolExecutor(16) as ex:
            list(ex.map(width, range(1, 17)))

    @phase("4 DeviceCompressedArray 512 MB, entropy=True 64 MB u8", devs)
    def _():
        arr = st.DeviceCompressedArray.from_array(data.view(np.int32))
        check(arr.to_array().view(np.uint8).tobytes() == data.tobytes(),
              "DeviceCompressedArray.to_array differs from the input")
        sb = arr.slab_bytes
        for i in (0, arr.n_slabs // 2, arr.n_slabs - 1):
            check(np.asarray(arr.slab(i)).tobytes()
                  == data[i * sb : (i + 1) * sb].tobytes(), f"slab {i}")
        check(fr.decompress(arr.serialize(), 4).tobytes() == data.tobytes(),
              "serialize() does not decode through frame.decompress")
        adopted = st.DeviceCompressedArray.deserialize(frames["host1"],
                                                       np.int32)
        check(adopted.to_array().view(np.uint8).tobytes()
              == prefix.tobytes(), "deserialize of a host-made frame")
        # block-codec residuals of sorted int32 are near-uniform, so the
        # entropy stage (rightly) switches itself off there: give it bytes
        # with a skewed alphabet, where it engages
        p = 1.0 / np.arange(1, 31) ** 2
        skew = np.random.default_rng(3).choice(
            np.arange(97, 127, dtype=np.uint8), PREFIX, p=p / p.sum())
        ent = st.DeviceCompressedArray.from_array(skew, entropy=True)
        check(ent._entropy is not None, "entropy stage did not engage")
        check(ent.to_array().tobytes() == skew.tobytes(),
              "entropy=True to_array differs from the input")
        i = ent.n_slabs // 3
        check(np.asarray(ent.slab(i)).tobytes()
              == skew[i * ent.slab_bytes : (i + 1) * ent.slab_bytes]
              .tobytes(), "entropy=True slab read")
        check(fr.decompress(ent.serialize(), 1).tobytes() == skew.tobytes(),
              "entropy=True serialize()")

    @phase("5 device entropy stage: text and records, 64 MB each", devs)
    def _():
        sys.path.insert(0, os.path.join(ROOT, "benchs"))
        import datasets

        eng = JaxEngine()
        for name, raw in (("text", datasets.text_u8(PREFIX)),
                          ("records", datasets.records_u8(PREFIX))):
            f = st.compress(raw, 1, 2, engine="auto", entropy="device")
            host = st.decompress(f, 1)
            dev = st.decompress(f, 1, engine=eng)
            check(host.tobytes() == raw, f"{name}: libzstd decode differs")
            check(np.asarray(dev).tobytes() == raw,
                  f"{name}: device decode differs")
            print(f"  {name}: ratio {len(raw) / len(f):.4f}", flush=True)

    @phase("6 time-limited mode, device engine, 64 MB", devs)
    def _():
        ctx = st.Context(level=2, engine=JaxEngine())
        ctx.set_max_nanoseconds(2_000_000_000)
        f = st.compress_generic(ctx, prefix, 4)
        check(st.decompress(f, 4).tobytes() == prefix.tobytes(),
              "time-limited frame does not decode back")


def four_cards(devs):
    from jax.sharding import Mesh

    import stenos_tpu as st
    from stenos_tpu.parallel import (compress_device_sharded,
                                     compress_device_sharded_gathered)

    mesh = Mesh(np.asarray(devs), ("chunks",))
    data = sorted_int32(4 * HEADLINE, seed=42)
    batch = data.reshape(-1, SB)
    frames = {}

    @phase("sharded st.compress/st.decompress 2 GB on 4 cards", devs)
    def _():
        for level in (1, 2):
            f = st.compress(data, 4, level, mesh=mesh)
            single = st.compress(data, 4, level, engine="auto")
            check(f == single, f"level {level}: mesh frame differs from "
                  "the single-card frame")
            back = st.decompress(f, 4, mesh=mesh)
            check(back.tobytes() == data.tobytes(),
                  f"level {level}: mesh decode differs from the input")
            frames[level] = single

    @phase("sharded device-resident frames 2 GB on 4 cards", devs)
    def _():
        # the single-card reference is the level-1 st.compress frame: one
        # card cannot hold compress_frame_device_jit's working set at 2 GB,
        # and the one-card run checks that the two frames are equal
        single = np.frombuffer(frames[1], np.uint8)
        fr_, nr = compress_device_sharded(batch, 4, 1, mesh)
        shards = {s.device for s in fr_.addressable_shards}
        check(shards == set(devs), f"ragged frame lives on {shards}")
        check(all(s.data.shape[0] == fr_.shape[0] // 4
                  for s in fr_.addressable_shards), "uneven shards")
        check(np.array_equal(np.asarray(fr_)[: int(nr)], single),
              "ragged sharded frame differs from the single-card frame")
        del fr_
        fg, ng = compress_device_sharded_gathered(batch, 4, 1, mesh)
        check(np.array_equal(np.asarray(fg)[: int(ng)], single),
              "gathered sharded frame differs from the single-card frame")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path on four GPUs")
    args = ap.parse_args()
    n_cards = 4 if args.four else 1
    devs = environment(n_cards)
    (four_cards if args.four else one_card)(devs)
    import jax

    d0 = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d0.platform, "kind": d0.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
