#!/usr/bin/env python
"""Randomized differential fuzz: ours vs the C++ reference and libzstd.

Each iteration draws (generator, bpp, level, size, dst slack) and checks:
  - compress() is BIT-EXACT vs the reference oracle (same level map)
  - decompress(ours) round-trips; the reference decodes our frame
  - tight dst budgets fail with the same error behavior as the reference
  - a random zstd frame (libzstd, random level) decodes through the
    device entropy tiers bit-exact

Complements the fixed grids in tests/ (reference test strategy,
tests_comp_decomp.cpp:163-216) with random sizes including partial
blocks and superblock-boundary straddles.

Usage: python tools/fuzz_parity.py [--seconds 600] [--seed 0]

Keep --seconds <= ~700 per process and loop over seeds in a shell: the
XLA:CPU JIT intermittently segfaulted late in long single-process runs
that compile many programs.
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tests"))


def gen(rng, kind, bpp, nbytes):
    nelem = nbytes // bpp + 1
    if kind == "random":
        a = rng.integers(0, 1 << min(8 * bpp - 1, 60), nelem, np.int64)
    elif kind == "sorted":
        a = np.sort(rng.integers(0, 1 << min(8 * bpp - 1, 60), nelem,
                                 np.int64))
    elif kind == "same":
        a = np.full(nelem, int(rng.integers(0, 1 << 16)), np.int64)
    elif kind == "rle":
        a = np.repeat(rng.integers(0, 50, nelem // 9 + 1, np.int64),
                      9)[:nelem]
    elif kind == "smallrange":
        a = rng.integers(0, 17, nelem, np.int64)
    else:  # records
        pool = rng.integers(0, 64, (37, 64), np.uint8)
        idx = rng.integers(0, 37, nbytes // 64 + 1)
        return pool[idx].reshape(-1)[:nbytes].tobytes()
    if bpp in (1, 2, 4, 8):
        return a.astype(f"<u{bpp}").tobytes()[:nbytes]
    return b"".join(int(v).to_bytes(16, "little")[:bpp]
                    for v in a)[:nbytes]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=600)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--one", type=int, default=None,
                    help="run exactly one iteration with this it_seed")
    ap.add_argument("--entropy-every", type=int, default=10,
                    help="device entropy tier check every N iters")
    ap.add_argument("--engine-every", type=int, default=25,
                    help="device-engine-vs-host frame identity check "
                         "every N iters (0 = off)")
    ap.add_argument("--custom-every", type=int, default=15,
                    help="custom-blocksize (cvector bucket) frame check "
                         "every N iters (0 = off)")
    args = ap.parse_args()

    import zstandard

    import _oracle as oracle
    import stenos_tpu as st
    from stenos_tpu.entropy.device_decode import decode_payload_device

    master = np.random.default_rng(args.seed)
    kinds = ["random", "sorted", "same", "rle", "smallrange", "records"]
    t_end = time.time() + args.seconds
    iters = fails = 0
    ap_one = args.one if hasattr(args, "one") else None
    while time.time() < t_end:
        if ap_one is not None and iters:
            break
        iters += 1
        it_seed = int(master.integers(0, 2**63)) if ap_one is None \
            else ap_one
        rng = np.random.default_rng(it_seed)
        bpp = int(rng.integers(1, 17))
        level = int(rng.integers(0, 10))
        nbytes = int(rng.integers(0, 600_000))
        nbytes -= nbytes % bpp
        kind = kinds[int(rng.integers(0, len(kinds)))]
        data = gen(rng, kind, bpp, nbytes)
        nbytes = len(data)  # generators may come up short; sizes must agree
        tag = (f"iter {iters} seed={it_seed}: {kind} bpp={bpp} "
               f"lvl={level} n={nbytes}")
        try:
            mine = st.compress(np.frombuffer(data, np.uint8), bpp, level)
            ref = oracle.compress(data, bpp, level)
            if mine != ref:
                # KNOWN divergence: the reference's LZ hash table is a
                # reused stack slot that (single-threaded, level 1) leaks
                # across superblocks (block_compress.h:1211); we scope it
                # per superblock to keep superblocks shard-independent
                # (NOTES.md). If every superblock encodes identically in
                # isolation, the difference is exactly that leak.
                _, sbsz, hdr = st.get_info(ref, bpp)
                per_sb_ok = all(
                    st.compress(np.frombuffer(
                        data[o : o + sbsz], np.uint8), bpp, level)
                    == oracle.compress(data[o : o + sbsz], bpp, level)
                    for o in range(0, len(data), max(sbsz, 1)))
                if per_sb_ok and st.decompress(
                        mine, bpp).tobytes() == data and oracle.decompress(
                        mine, bpp, nbytes) == data:
                    print(f"known cross-superblock LZ divergence {tag}: "
                          f"{len(mine)} vs {len(ref)}")
                    continue
                fails += 1
                print(f"FAIL bits {tag}: {len(mine)} vs {len(ref)}")
                continue
            if st.decompress(mine, bpp).tobytes() != data:
                fails += 1
                print(f"FAIL roundtrip {tag}")
                continue
            if nbytes:
                try:
                    oracle_back = oracle.decompress(mine, bpp, nbytes)
                except Exception:
                    oracle_back = None  # ref decoder error (it raises)
                if oracle_back != data:
                    # reference bug: exact superblock multiples rejected
                    # (stenos.cpp:1131, NOTES.md) — it fails on its OWN
                    # frames there too; not our failure
                    _, sbsz, _ = st.get_info(mine, bpp)
                    if nbytes % sbsz:
                        fails += 1
                        print(f"FAIL oracle-decode {tag}")
                        continue
            # tight destination: both sides must fail gracefully
            if len(mine) > 16:
                tight = int(rng.integers(0, len(mine)))
                ours_err = refs_err = False
                try:
                    st.compress(np.frombuffer(data, np.uint8), bpp, level,
                                dst_size=tight)
                except st.StenosError:
                    ours_err = True
                refs_err = oracle.compress_bounded_fails(data, bpp, level,
                                                         tight) \
                    if hasattr(oracle, "compress_bounded_fails") else ours_err
                if ours_err != refs_err:
                    fails += 1
                    print(f"FAIL dst-behavior {tag} tight={tight}")
            if (args.entropy_every and iters % args.entropy_every == 0
                    and nbytes > 1024):
                zl = int(rng.integers(1, 20))
                c = zstandard.ZstdCompressor(level=zl).compress(data)
                out = decode_payload_device(c, len(data))
                if out is not None and bytes(
                        np.asarray(out).tobytes()) != data:
                    fails += 1
                    print(f"FAIL entropy-tier {tag} zl={zl}")
            if (args.engine_every and iters % args.engine_every == 0
                    and 0 < nbytes <= 300_000):
                from stenos_tpu.engine_jax import JaxEngine

                fe = st.compress(np.frombuffer(data, np.uint8), bpp, level,
                                 engine=JaxEngine())
                if fe != mine:
                    fails += 1
                    print(f"FAIL engine-vs-host {tag}: "
                          f"{len(fe)} vs {len(mine)}")
            if (args.custom_every and iters % args.custom_every == 0
                    and 0 < nbytes <= 300_000):
                # custom-blocksize frames (the cvector bucket format,
                # shift=255 header): the reference must decode them
                shift = int(rng.integers(0, 8))
                fc = st.compress(np.frombuffer(data, np.uint8), bpp, level,
                                 custom_shift=shift)
                if st.decompress(fc, bpp).tobytes() != data:
                    fails += 1
                    print(f"FAIL custom-shift roundtrip {tag} s={shift}")
                elif nbytes and oracle.decompress(
                        fc, bpp, nbytes) != data:
                    _, sbsz, _ = st.get_info(fc, bpp)
                    if nbytes % sbsz:  # not the exact-multiple ref bug
                        fails += 1
                        print(f"FAIL custom-shift oracle {tag} s={shift}")
        except Exception as e:  # noqa: BLE001
            fails += 1
            print(f"FAIL exception {tag}: {e!r}")
        if iters % 25 == 0:
            print(f"... {iters} iters, {fails} fails")
        if ap_one is not None:
            break
    print(f"DONE: {iters} iterations, {fails} failures")
    sys.exit(1 if fails else 0)


if __name__ == "__main__":
    main()
