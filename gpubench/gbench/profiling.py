"""Reading a torch.profiler trace of the timed path: the device's busy
time (the union of its activity intervals), each device operation's time
by name, and the host's activity in the device's idle gaps.

The profiler use follows ``chip_smoke.profile_picture`` and
``chip_smoke.measured_device_ms`` (profile again while the profiler sees
no device time); the reading is the benchmark's own.
"""
from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict
from dataclasses import dataclass, field

HOST_WAIT = "host outside any traced op"
SHORT_US = 1000.0
# the harness's own spans (torch.profiler.record_function): host events,
# never device activity, though the profiler also draws them on the
# device's timeline
SPANS = ("FusedDecoder.decode", "gpubench.request")
_GENERIC = ("elementwise_kernel", "vectorized_elementwise_kernel",
            "unrolled_elementwise_kernel", "index_elementwise_kernel",
            "reduce_kernel")


def kernel_name(name: str) -> str:
    """A device operation's function name without its namespaces,
    template arguments and parameters:
    "(anonymous namespace)::intra_scan_kernel((anonymous namespace)::
    ScanArgs)" -> "intra_scan_kernel"."""
    s = name.replace("(anonymous namespace)::", "")
    if s.startswith("void "):
        s = s[5:]
    for stop in ("(", "<"):
        k = s.find(stop)
        if k > 0:
            s = s[:k]
    return s.split("::")[-1].strip()


def short_name(name: str) -> str:
    """kernel_name, with the functor of PyTorch's generic kernels."""
    base = kernel_name(name)
    if base in _GENERIC:
        m = re.search(r"(\w+(?:Functor|_kernel_impl|_kernel_cuda|_kernel))"
                      r"(?:<|\(|::)", name[len(base):]
                      if name.startswith(base) else
                      name[name.find(base) + len(base):])
        if m:
            return f"{base}[{m.group(1)}]"
    return base


@dataclass
class Trace:
    busy_s: float                 # union of device activity intervals
    window_s: float               # host wall time of the traced stretch
    device_s: dict = field(default_factory=dict)   # op name -> seconds
    gaps_s: dict = field(default_factory=dict)     # host label -> seconds

    def device_seconds(self, kernels) -> float:
        """Device seconds of the operations whose function name
        (kernel_name) is one of `kernels`."""
        return sum(s for name, s in self.device_s.items()
                   if kernel_name(name) in kernels)

    def breakdown(self, n: int = 10):
        by = defaultdict(float)
        for name, s in self.device_s.items():
            by[short_name(name)] += s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.gaps_s.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gaps]}


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def read(events, window_s: float) -> Trace | None:
    """A Trace from the profiler's events (times in us); None where it saw
    no device activity."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in events:
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or e.name in SPANS:
                continue
            if tr.end > tr.start:
                dev.append((tr.start, tr.end, e.name))
        elif tr.end > tr.start:
            host.append((tr.start, tr.end, e.name))
    if not dev:
        return None
    device_s = defaultdict(float)
    for s, e, name in dev:
        device_s[name] += (e - s) / 1e6
    merged = _union([(s, e) for s, e, _ in dev])
    busy = sum(e - s for s, e in merged) / 1e6
    gaps_s = defaultdict(float)
    # the innermost host event at a gap's midpoint is the covering one
    # that started last: short events (under SHORT_US) are searched back
    # from the midpoint by start time, the few long ones in full
    short = sorted(h for h in host if h[1] - h[0] < SHORT_US)
    long_ = [h for h in host if h[1] - h[0] >= SHORT_US]
    starts = [h[0] for h in short]
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = (a + b) / 2
        label, start = HOST_WAIT, None
        k = bisect.bisect_right(starts, mid) - 1
        while k >= 0 and short[k][0] >= mid - SHORT_US:
            s, e, name = short[k]
            if e >= mid:
                label, start = name, s
                break
            k -= 1
        for s, e, name in long_:
            if s <= mid <= e and (start is None or s > start):
                label, start = name, s
        gaps_s[label] += (b - a) / 1e6
    return Trace(busy_s=busy, window_s=window_s, device_s=dict(device_s),
                 gaps_s=dict(gaps_s))


def profile(fn, sync, tries: int = 5) -> Trace | None:
    """Run fn() under torch.profiler (host and device activity), synced,
    up to `tries` times while the profiler sees no device activity."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    for _ in range(tries):
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            sync()
            wall = time.perf_counter() - t0
        tr = read(prof.events(), wall)
        if tr is not None:
            return tr
    return None
