"""The traced run's reading of the device: ``torch.profiler`` over the
measured window, device events only.

Only device activity is recorded (kernels, copies, sets), so the host runs
as it does untraced but for the profiler's own start and stop, which lie
outside the window.  The events' times are on the host's ``time.time_ns``
clock, as the window's bounds and the benchmark's spans are, so an idle gap
on a device can be put beside what the host was doing then.
"""

import bisect
import collections

import torch
from torch.profiler import ProfilerActivity, profile


def merge(intervals):
    """Sorted, non-overlapping union of ``(start, end)`` intervals."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


class Tracer:
    """Context manager around the window; :meth:`read` then keeps, per
    device index, the events ``(name, start_ns, end_ns)``."""

    def __init__(self, devices):
        self.indices = [d.index for d in devices if d.type == "cuda"]
        self.events = {i: [] for i in self.indices}
        self.spans = []
        self.window_s = None

    def __enter__(self):
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)

    def read(self, window):
        self.open_ns, self.close_ns = window.open_ns, window.close_ns
        self.window_s = (window.close_ns - window.open_ns) / 1e9
        self.spans = window.spans
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            if e.device_index() in self.events:
                self.events[e.device_index()].append(
                    (e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
        del self.prof

    def busy_intervals(self, index):
        return clip(merge((s, e) for _, s, e in self.events[index]),
                    self.open_ns, self.close_ns)

    def busy_s(self, index):
        """Seconds of the window in which an operation ran on the device."""
        return sum(e - s for s, e in self.busy_intervals(index)) / 1e9

    def busy_mean_s(self):
        return sum(self.busy_s(i) for i in self.indices) / len(self.indices)

    def kernel_events(self, match):
        """Every device's events whose name ``match`` accepts."""
        return [(n, s, e) for i in self.indices for n, s, e in self.events[i]
                if match(n)]

    def breakdown(self, top=10):
        """The device operations that took most time (summed over the
        devices) and the idle gaps, by the benchmark span the host was in
        at the gap's middle (averaged over the devices); seconds."""
        ops = collections.Counter()
        for i in self.indices:
            for name, s, e in self.events[i]:
                ops[name] += (e - s) / 1e9
        idle = collections.Counter()
        spans = sorted(self.spans, key=lambda sp: sp[1])
        starts = [s for _, s, _ in spans]
        for i in self.indices:
            busy = self.busy_intervals(i)
            edges = [self.open_ns] + [x for iv in busy for x in iv] \
                + [self.close_ns]
            for lo, hi in zip(edges[0::2], edges[1::2]):
                if hi <= lo:
                    continue
                mid = (lo + hi) // 2
                k = bisect.bisect_right(starts, mid) - 1
                name = (spans[k][0] if k >= 0 and mid < spans[k][2]
                        else "host outside the benchmark's spans")
                idle[name] += (hi - lo) / 1e9 / len(self.indices)
        return {"device_ops": [[n, v] for n, v in ops.most_common(top)],
                "idle_gaps": [[n, v] for n, v in idle.most_common(top)]}
