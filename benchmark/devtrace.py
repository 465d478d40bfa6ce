"""Reduce a torch.profiler chrome trace to device busy time, device time
by operation name, and idle gaps labelled by host activity.

Device activity is the union of the trace's `kernel`, `gpu_memcpy` and
`gpu_memset` events on each card, clipped to the window, which is the
benchmark's own `record_function` span named `window`.  An idle gap is a
stretch of the window in which a card ran nothing; it is labelled by the
innermost host event on the window's thread that covers the gap's middle
(the benchmark's spans, torch operators, CUDA runtime calls).
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce_trace(events, window_name: str = "window", top: int = 10):
    """Busy seconds a card, device seconds by name, idle seconds by host
    label, and the window's length, from chrome-trace `events`."""
    wins = [e for e in events if e.get("ph") == "X"
            and e.get("name") == window_name
            and e.get("cat") in HOST_CATS]
    if not wins:
        raise ValueError(f"no `{window_name}` span in the trace")
    win = max(wins, key=lambda e: float(e.get("dur", 0)))
    w0 = float(win["ts"])
    w1 = w0 + float(win["dur"])
    per_dev = defaultdict(list)
    by_name = defaultdict(float)
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e.get("dur", 0)), w1)
        if t <= s:
            continue
        dev = (e.get("args") or {}).get("device", e.get("pid"))
        per_dev[dev].append((s, t))
        by_name[e.get("name", "?")] += (t - s) * 1e-6
    # by start, the outer of two spans that start together first
    host = sorted(
        ((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
          e.get("name", "?"))
        for e in events
        if e.get("ph") == "X" and e.get("cat") in HOST_CATS
        and e.get("tid") == win.get("tid") and e.get("pid") == win.get("pid")),
        key=lambda h: (h[0], -h[1]))
    starts = [h[0] for h in host]
    parent = []          # the span each host span sits in, or -1
    stack = []
    for i, (s, e, _) in enumerate(host):
        while stack and host[stack[-1]][1] < s:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)

    def label(t):
        j = bisect.bisect_right(starts, t) - 1
        while j >= 0 and host[j][1] < t:
            j = parent[j]
        return host[j][2] if j >= 0 else window_name

    busy = {}
    idle = defaultdict(float)
    for dev, iv in per_dev.items():
        merged = _union(iv)
        busy[dev] = sum(e - s for s, e in merged) * 1e-6
        edges = [w0] + [x for s, e in merged for x in (s, e)] + [w1]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                idle[label((a + b) / 2)] += (b - a) * 1e-6
    ndev = max(1, len(per_dev))
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy,
        "device_s_by_name": dict(by_name),
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
        "idle_gaps": sorted(((k, v / ndev) for k, v in idle.items()),
                            key=lambda kv: -kv[1])[:top],
    }


def load(path: str):
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data
