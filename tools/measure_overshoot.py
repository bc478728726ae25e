#!/usr/bin/env python
"""Measure time-limited overshoot on real hardware (VERDICT r2 item 8).

Runs compress_generic under a grid of budgets on the live device engine
and reports the overshoot distribution (elapsed - budget, positive side
only). The reference claims <= ~1 ms overshoot on its thread pool
(README.md:102-107, stenos.h:152-154); the device engine's bound is one
shrinking round (25% of remaining budget at the conservative rate),
which converges to the last round's dispatch time.

Usage: python tools/measure_overshoot.py [--mb 64] [--trials 5]
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import stenos_tpu as st  # noqa: E402
from stenos_tpu.engine_jax import JaxEngine  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=64)
    ap.add_argument("--trials", type=int, default=5)
    args = ap.parse_args()

    rng = np.random.default_rng(0)
    n = args.mb << 20
    data = np.sort(rng.integers(0, 1 << 28, n // 4).astype(np.uint32)) \
        .view(np.uint8)

    engine = JaxEngine()
    # warm the bucketed round shapes for THIS input size so compiles
    # don't masquerade as overshoot (Context.warmup = the reference's
    # pool-at-init analog); block levels 0-2 cover the controller's range
    ctx = st.Context(max_nanoseconds=1, engine=engine)
    ctx.warmup(4, n, block_levels=(0, 1, 2))
    ctx = st.Context(max_nanoseconds=60_000_000_000, engine=engine)
    st.compress_generic(ctx, data[: 8 << 20], 4)

    print(f"{'budget_ms':>10} {'elapsed_ms':>11} {'overshoot_ms':>13}")
    overs = []
    for budget_ms in (50, 100, 200, 400, 800):
        for _ in range(args.trials):
            ctx = st.Context(max_nanoseconds=budget_ms * 1_000_000,
                             engine=engine)
            t0 = time.perf_counter_ns()
            frame = st.compress_generic(ctx, data, 4)
            el = (time.perf_counter_ns() - t0) / 1e6
            over = max(el - budget_ms, 0.0)
            overs.append(over)
            print(f"{budget_ms:>10} {el:>11.1f} {over:>13.1f}")
            assert st.decompress(frame, 4).tobytes() == data.tobytes()
    overs = np.asarray(overs)
    print(f"overshoot p50={np.percentile(overs, 50):.1f} ms "
          f"p95={np.percentile(overs, 95):.1f} ms max={overs.max():.1f} ms")


if __name__ == "__main__":
    main()
