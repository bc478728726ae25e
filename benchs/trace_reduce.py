"""Reduce a jax.profiler trace to device time.

    device_times(logdir) -> {"kernels": {name: ns}, "busy_ns": int,
                             "window_ns": int, "lines": {name: events}}

On the GPU the device planes ("/device:GPU:<n>") carry one line per CUDA
stream ("Stream #13(Compute)", ...), each event a kernel or a device
memcpy. "kernels" sums the durations per event name; "busy_ns" is the
union of all event intervals on the stream lines, and "window_ns" spans
the first to the last device event, so 1 - busy/window is the device's
idle share over the traced window.
"""

import glob
import os


def _latest_xplane(logdir: str) -> str:
    paths = glob.glob(os.path.join(logdir, "plugins", "profile", "*",
                                   "*.xplane.pb"))
    if not paths:
        raise FileNotFoundError(f"no .xplane.pb under {logdir}")
    return max(paths, key=os.path.getmtime)


def _union_ns(intervals) -> int:
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def device_times(logdir: str) -> dict:
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(_latest_xplane(logdir))
    kernels, spans, lines = {}, [], {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU:"):
            continue
        for line in plane.lines:
            evs = list(line.events)
            lines[f"{plane.name}/{line.name}"] = len(evs)
            if not line.name.startswith("Stream"):
                continue
            for ev in evs:
                spans.append((ev.start_ns, ev.end_ns))
                kernels[ev.name] = kernels.get(ev.name, 0) + ev.duration_ns
    window = (max(e for _, e in spans) - min(s for s, _ in spans)
              if spans else 0)
    return {"kernels": kernels, "busy_ns": _union_ns(spans),
            "window_ns": window, "lines": lines}
