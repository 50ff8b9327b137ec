"""The traced window: torch.profiler's events reduced to what the
per-layer readers read.

A traced run profiles a few iterations (the traffic's trace_iters)
with the device's activity alone, over a window timed by the host's
clock, and then one iteration with the host's operators too, inside one
record_function range, WINDOW, whose host span is that window. From the
events it keeps the device operations (kernels, memsets, copies) as
(name, start_us, end_us), the host operators as (name, start_us,
end_us), and the window's span, on the profiler's one clock. A
record_function range shows on the device as a user annotation spanning
the kernels launched inside it; it is a window and no work, so it counts
in no device time.
"""

from __future__ import annotations

import bisect
import dataclasses

WINDOW = "portbench_window"


def union_us(ranges) -> float:
    """Total length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(ranges):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(ranges) -> list:
    """The union of [start, end) intervals as disjoint sorted intervals."""
    out = []
    for s, e in sorted(ranges):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def short_name(name: str) -> str:
    """A device operation's name without namespaces, templates and
    arguments."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith(("Memset", "Memcpy")):
        return name.split(" ")[0]
    name = name.removeprefix("void ").split("<")[0].split("(")[0]
    return name.split("::")[-1]


@dataclasses.dataclass
class Trace:
    device_ops: list     # [(name, start_us, end_us)] on the device
    host_ops: list       # [(name, start_us, end_us)] on the host
    window: tuple        # (start_us, end_us) of WINDOW's host span, or
                         # None: every device operation is in the window
    wall_us: float = None  # the window's length, where window is None

    @property
    def window_us(self) -> float:
        if self.window is None:
            return self.wall_us
        return self.window[1] - self.window[0]

    def in_window(self, ops=None) -> list:
        ops = self.device_ops if ops is None else ops
        if self.window is None:
            return list(ops)
        w0, w1 = self.window
        return [(n, max(s, w0), min(e, w1)) for n, s, e in ops
                if min(e, w1) > max(s, w0)]

    def kernels(self) -> list:
        """The window's device kernels (no memsets or copies)."""
        return [op for op in self.in_window()
                if not op[0].startswith(("Memset", "Memcpy"))]

    def busy_us(self) -> float:
        return union_us([(s, e) for _, s, e in self.in_window()])

    def top_ops(self, k: int = 10) -> list:
        """[[name, seconds]] of the k device operations that took the
        most time, summed by short name."""
        tot = {}
        for n, s, e in self.in_window():
            n = short_name(n)
            tot[n] = tot.get(n, 0.0) + (e - s)
        return [[n, us / 1e6] for n, us in
                sorted(tot.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """[[host operator, seconds]]: the device's idle time inside the
        window, each gap named by the innermost host operator running at
        its midpoint ("host idle" where none), summed by name, the k
        largest."""
        w0, w1 = self.window
        busy = merged([(s, e) for _, s, e in self.in_window()])
        gaps, t = [], w0
        for s, e in busy:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if w1 > t:
            gaps.append((t, w1))
        host = sorted((op for op in self.host_ops if op[0] != WINDOW),
                      key=lambda op: op[1])
        starts = [op[1] for op in host]
        tot = {}
        for s, e in gaps:
            mid = (s + e) / 2
            # the latest-started operator still running at mid is the
            # innermost of the ranges nested around it
            name = "host idle"
            for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                if host[j][2] >= mid:
                    name = host[j][0]
                    break
            tot[name] = tot.get(name, 0.0) + (e - s)
        return [[n, us / 1e6] for n, us in
                sorted(tot.items(), key=lambda kv: -kv[1])[:k]]


def from_profiler(prof, wall_us=None) -> Trace:
    """The Trace of a torch.profiler run: with wall_us, of a run that
    recorded the device alone over a window of that length; else of one
    that held one WINDOW range on the host."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    dev, host, window = [], [], None
    for e in prof.events():
        span = (e.time_range.start, e.time_range.end)
        if e.device_type == cuda:
            if getattr(e, "is_user_annotation", False) or e.name == WINDOW:
                continue
            dev.append((e.name,) + span)
        else:
            if e.name == WINDOW:
                window = span
            host.append((e.name,) + span)
    if wall_us is not None:
        window = None
    elif window is None:
        raise RuntimeError("the trace holds no window range")
    return Trace(device_ops=sorted(set(dev), key=lambda op: op[1]),
                 host_ops=host, window=window, wall_us=wall_us)
