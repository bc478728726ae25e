"""Write tests/data/parity_digests.json: SHA-256 digests of the host-path
frames (and the error codes of too-small destinations) over the parity
grid of tests/_parity_cases.py, which the oracle tests compare with when
the C++ reference is absent.

Run with the checkout whose host path is the reference on PYTHONPATH:

    PYTHONPATH=/path/to/checkout python tools/gen_parity_digests.py [-j 6]
"""

import argparse
import json
import os
import sys
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context

TESTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tests")
sys.path.insert(0, TESTS)

import _parity_cases as pc  # noqa: E402


def _frames(group):
    from stenos_tpu import frame as fr

    kind, a, b = group
    if kind == "bit_exact":
        cases = pc.bit_exact_cases(a, b)
    elif kind == "mid":
        cases = pc.mid_level_cases(a, b)
    elif kind == "lz_table":
        cases = ((key, data, 1, bpp) for key, data, bpp
                 in pc.lz_table_cases())
        return {key: pc.sha(fr.compress(data, bpp, level))
                for key, data, level, bpp in cases}
    else:
        key, data, bpp = pc.lz_tail_case()
        return {key: pc.sha(fr.compress(data, bpp, 1))}
    return {key: pc.sha(fr.compress(data, b, level))
            for key, data, level in cases}


def _outcome(fr, data, bpp, level, dst_size):
    try:
        return pc.sha(fr.compress(data, bpp, level, dst_size=dst_size))
    except fr.StenosError as e:
        return e.code


def _shrink(case):
    from stenos_tpu import frame as fr

    bpp, kind, level = case
    data = pc.shrink_data(bpp, kind, level)
    full = len(fr.compress(data, bpp, level))
    return (f"{bpp}/{kind}/{level}",
            [[d, _outcome(fr, data, bpp, level, d)]
             for d in pc.shrink_sizes(full)])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-j", type=int, default=4, help="worker processes")
    args = ap.parse_args()
    groups = ([("bit_exact", k, b) for k in pc.KINDS for b in pc.ALL_BPP]
              + [("mid", lv, b) for lv in pc.MID_LEVELS for b in pc.ALL_BPP]
              + [("lz_table", None, None), ("lz_tail", None, None)])
    shrink = [(b, k, lv) for b in pc.SHRINK_BPP for k in pc.SHRINK_KINDS
              for lv in pc.SHRINK_LEVELS]
    with ProcessPoolExecutor(args.j, mp_context=get_context("spawn")) as ex:
        frames = {}
        for part in ex.map(_frames, groups):
            frames.update(part)
        shr = dict(ex.map(_shrink, shrink))
    from stenos_tpu import constants, frame as fr

    data = pc.shrink_parity_data()
    full = len(fr.compress(data, 4, 2))
    out = {
        "frames": dict(sorted(frames.items())),
        "shrink": shr,
        "shrink_parity": [[d, _outcome(fr, data, 4, 2, d)]
                          for d in pc.shrink_parity_sizes(full)],
        "bound": {str(n): constants.compress_bound(n)
                  for n in pc.BOUND_SIZES},
    }
    os.makedirs(os.path.dirname(pc.DIGESTS), exist_ok=True)
    with open(pc.DIGESTS, "w") as f:
        json.dump(out, f, indent=0, sort_keys=True)
        f.write("\n")
    print(f"{len(frames)} frames, {len(shr)} shrink cases -> {pc.DIGESTS}")


if __name__ == "__main__":
    main()
