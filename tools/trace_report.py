"""Reduce a jax.profiler trace to device busy share and per-op device time.

Usage: python tools/trace_report.py <trace dir> [--div N] [--top K]

Reads the newest ``*.xplane.pb`` under the directory with
``jax.profiler.ProfileData`` and, for every GPU device plane
(``/device:GPU:<n>``), prints:
  - the device's busy time (the union of the intervals in which a kernel
    ran on one of its streams), the wall span from the first kernel start to
    the last kernel end, and the busy share of that span;
  - the K device ops with the most total time (count, total ms, mean us,
    ms per unit): each kernel's HLO op (its ``hlo_op`` stat), or the
    kernel's own name (XLA names fusion kernels after the fusion) where the
    op is a whole command buffer (CUDA graph) or unnamed;
  - the largest gaps between kernels.
``--div N`` divides the totals by N (frames, repetitions) for per-unit cost.
Pure host-side parsing: it needs no device.
"""

from __future__ import annotations

import glob
import os
import sys
from collections import defaultdict

OP_STAT = "hlo_op"
GRAPH_OP = "command_buffer"  # XLA:GPU runs op sequences as CUDA graphs


def newest_xplane(root: str) -> str:
    paths = sorted(glob.glob(os.path.join(root, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        raise SystemExit(f"no .xplane.pb under {root}")
    return paths[-1]


def _union_ns(intervals):
    """Total length and the gaps of a set of (start, end) intervals."""
    busy, gaps, end = 0, [], None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                gaps.append((s - end, end))
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy, gaps


def _op_name(event) -> str:
    for key, value in event.stats:
        if key == OP_STAT and str(value) != GRAPH_OP:
            return str(value)
    return event.name


def reduce_planes(planes):
    """Per-device summary from ``ProfileData.planes`` (or any objects with
    ``name``, ``lines`` -> ``name``, ``events`` -> ``name``, ``start_ns``,
    ``duration_ns``). Returns {device name: summary dict}."""
    out = {}
    for plane in planes:
        if not plane.name.startswith("/device:GPU:"):
            continue
        kernels, ops = [], defaultdict(lambda: [0, 0.0])
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for e in line.events:
                s, d = float(e.start_ns), float(e.duration_ns)
                kernels.append((s, s + d))
                name = _op_name(e)
                ops[name][0] += 1
                ops[name][1] += d
        if not kernels:
            continue
        busy, gaps = _union_ns(kernels)
        t0 = min(s for s, _ in kernels)
        t1 = max(e for _, e in kernels)
        out[plane.name] = {
            "busy_ns": busy,
            "span_ns": t1 - t0,
            "busy_share": busy / max(t1 - t0, 1.0),
            "n_kernels": len(kernels),
            "top_ops": sorted(((n, c, d) for n, (c, d) in ops.items()),
                              key=lambda r: -r[2]),
            "gaps": sorted(gaps, reverse=True),
        }
    return out


def reduce_trace(root: str):
    from jax.profiler import ProfileData

    path = newest_xplane(root)
    return path, reduce_planes(ProfileData.from_file(path).planes)


def format_report(path: str, devices, div: float = 1.0, top: int = 10):
    lines = [f"# {path} (div={div:g})"]
    for dev, r in devices.items():
        lines.append(
            f"{dev}: busy {r['busy_ns'] / 1e6:.3f} ms of a "
            f"{r['span_ns'] / 1e6:.3f} ms span, busy share "
            f"{100 * r['busy_share']:.1f}%, {r['n_kernels']} kernels "
            f"(per unit: busy {r['busy_ns'] / 1e6 / div:.3f} ms)")
        lines.append(f"  {'op':60s} {'n':>6s} {'tot ms':>9s} {'mean us':>9s}"
                     f" {'/unit ms':>9s}")
        for name, n, dur in r["top_ops"][:top]:
            lines.append(f"  {name[:60]:60s} {n:6d} {dur / 1e6:9.3f} "
                         f"{dur / n / 1e3:9.1f} {dur / 1e6 / div:9.3f}")
        gtot = sum(g for g, _ in r["gaps"])
        lines.append(f"  gaps: {gtot / 1e6:.3f} ms over {len(r['gaps'])}; "
                     "largest: " + ", ".join(
                         f"{g / 1e6:.3f}" for g, _ in r["gaps"][:5]) + " ms")
    return "\n".join(lines)


def main():
    root = sys.argv[1]
    div = float(sys.argv[sys.argv.index("--div") + 1]) if "--div" in sys.argv \
        else 1.0
    top = int(sys.argv[sys.argv.index("--top") + 1]) if "--top" in sys.argv \
        else 10
    path, devices = reduce_trace(root)
    if not devices:
        raise SystemExit(f"no GPU device plane with kernels in {path}")
    print(format_report(path, devices, div, top))


if __name__ == "__main__":
    main()
