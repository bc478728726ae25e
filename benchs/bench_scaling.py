"""Scaling benchmark for the sharded compress pipeline (SURVEY §2.7).

Runs the ragged production path (parallel.compress_device_sharded) and the
round-4 gathered variant on CPU meshes of 1/2/4/8 virtual devices with a
FIXED per-device load (weak scaling) and records, per device count:

  - wall time and end-to-end GB/s;
  - the weak-scaling overhead factor T(nd) / (nd * T(1)). This host has ONE
    physical core, so every mesh partition serializes: ideal weak scaling is
    T(nd) = nd * T(1), and anything above it is the distribution machinery's
    added cost (collectives, assembly, host offset walk) — exactly the
    serial fraction that would cap real-pod scaling. A real pod runs the
    nd local parts concurrently, so its efficiency at nd chips is
    ~ 1 / overhead_factor(nd) under this model;
  - the per-chip collective traffic of both paths from the REAL buffer
    shapes (sharding.ragged_traffic_model): the gathered variant all-gathers
    padded rows (bytes ∝ UNCOMPRESSED input), the ragged path reduce_scatters
    frame shards sized from the measured compressed bytes (∝ COMPRESSED).

Usage:  python benchs/bench_scaling.py [--out BENCH_SCALING.json]
        (forces JAX_PLATFORMS=cpu with 8 virtual devices; run it in a fresh
        process, not after device work.)

Reference protocol analog: the thread sweep via STENOS_THREADS in
/root/reference/benchs/bench_all.cpp:271,292-298.
"""

import argparse
import json
import os
import sys
import time

if "jax" not in sys.modules:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )

import numpy as np  # noqa: E402

import jax  # noqa: E402


def _data(n_sb: int, sb: int, bpp: int, seed: int = 7):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 1 << 30, (n_sb * sb) // bpp, dtype=np.int64)
    return (np.sort(raw.astype(np.uint32)).view(np.uint8)
            .reshape(n_sb, sb))


def _time_runs(fn, reps: int = 3):
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def run(per_dev_sb: int = 8, sb: int = 131072, bpp: int = 4,
        device_counts=(1, 2, 4, 8), reps: int = 3) -> dict:
    from stenos_tpu.parallel import (compress_device_sharded,
                                     compress_device_sharded_gathered,
                                     encode_segments_sharded, make_mesh,
                                     ragged_traffic_model)
    from stenos_tpu.engine_jax import _bucket125

    results = {"per_dev_superblocks": per_dev_sb, "sb": sb, "bpp": bpp,
               "host_cores": os.cpu_count(), "mode": "weak-scaling",
               "notes": [
                   "1-core host: all mesh partitions serialize, so ideal "
                   "weak scaling is T(nd) = nd*T(1); overhead_factor is the "
                   "distribution machinery's added cost on top of that.",
                   "ragged overhead on CPU is the reduce_scatter executing "
                   "as real byte-adds (nd*S per device) — on GPUs that is "
                   "interconnect traffic; the traffic model is the "
                   "hardware-relevant comparator.",
                   "the gathered variant's single-device terminal assembly "
                   "(its serial fraction on real devices) cannot show up "
                   "on a 1-core host where everything is serial anyway.",
               ],
               "points": []}
    t1 = {}
    for nd in device_counts:
        if nd > len(jax.devices()):
            continue
        n_sb = per_dev_sb * nd
        data = _data(n_sb, sb, bpp)
        mesh = make_mesh(nd)

        def ragged():
            f, ln = compress_device_sharded(data, bpp, 1, mesh)
            jax.block_until_ready(f)
            return f, ln

        def gathered():
            f, ln = compress_device_sharded_gathered(data, bpp, 1, mesh)
            jax.block_until_ready(f)
            return f, ln

        fr_r, len_r = ragged()     # compile + correctness anchor
        fr_g, len_g = gathered()
        assert int(len_r) == int(len_g)
        assert (np.asarray(fr_r)[: int(len_r)]
                == np.asarray(fr_g)[: int(len_g)]).all(), nd

        tr = _time_runs(lambda: ragged(), reps)
        tg = _time_runs(lambda: gathered(), reps)
        t1.setdefault("ragged", {}).setdefault(nd, tr)
        t1.setdefault("gathered", {}).setdefault(nd, tg)

        # real shapes for the traffic accounting
        segs, seg_lens = encode_segments_sharded(mesh, data, bpp, 2)
        seg_lens = np.asarray(seg_lens, np.int64)
        C_loc = int(segs.shape[1])
        total = 8 + int(seg_lens.sum())
        S = _bucket125(-(-(total + C_loc) // nd))
        w = C_loc // per_dev_sb  # padded row width
        traffic = ragged_traffic_model(n_sb, w, nd, S, C_loc)
        traffic["compressed_frame_bytes"] = total

        base_r = t1["ragged"].get(device_counts[0], tr)
        base_g = t1["gathered"].get(device_counts[0], tg)
        nd0 = device_counts[0]
        point = {
            "devices": nd,
            "input_mb": round(n_sb * sb / 2**20, 2),
            "ragged_s": round(tr, 4),
            "gathered_s": round(tg, 4),
            "ragged_gbps": round(n_sb * sb / tr / 1e9, 4),
            "gathered_gbps": round(n_sb * sb / tg / 1e9, 4),
            "ragged_overhead_factor": round(tr / (nd / nd0 * base_r), 3),
            "gathered_overhead_factor": round(tg / (nd / nd0 * base_g), 3),
            "traffic": traffic,
        }
        results["points"].append(point)
        print(json.dumps(point), flush=True)
    if results["points"]:
        last = results["points"][-1]
        results["projected_pod_efficiency_ragged"] = round(
            1.0 / max(last["ragged_overhead_factor"], 1e-9), 3)
        results["projected_pod_efficiency_gathered"] = round(
            1.0 / max(last["gathered_overhead_factor"], 1e-9), 3)
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--per-dev-sb", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    res = run(per_dev_sb=args.per_dev_sb, reps=args.reps)
    print(json.dumps(res))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
