"""The reduction of one traced window (`torch.profiler`, CPU and CUDA
activity) to what the per-layer readers and the result's breakdown read:
the device's busy time (the union of the intervals in which an operation
ran on the card), the window's length (the `bench.traced` range), device
time by operation name, and the idle gaps labelled by what the host was
doing (the harness span and the innermost host operation at the gap)."""

import bisect
import dataclasses

WINDOW_RANGE = "bench.traced"
# idle gaps shorter than this are counted together, not looked up: the
# gaps between the kernels of a replayed graph
SHORT_GAP_NS = 10_000


def profiler():
    import torch
    from torch.profiler import ProfilerActivity

    return torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA])


@dataclasses.dataclass
class Summary:
    busy_s: float
    window_s: float
    device_ops: int
    op_s: dict        # device seconds by operation name
    op_n: dict        # launches by operation name
    idle_s: dict      # idle seconds by host activity


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _host_at(host, starts, t):
    """The innermost host range (shortest) that holds time t."""
    best = None
    last = bisect.bisect_right(starts, t) - 1
    for i in range(last, max(last - 2000, -1), -1):
        a, b, name = host[i]
        if b >= t and (best is None or b - a < best[1] - best[0]):
            best = (a, b, name)
    return None if best is None else best[2]


def reduce_events(events):
    """The Summary of a list of (kind, name, start_ns, end_ns), kind
    "device", "span" (a `bench.` range) or "host"."""
    window = [(a, b) for k, n, a, b in events
              if k == "span" and n == WINDOW_RANGE]
    if not window:
        return None
    w0, w1 = window[0]
    device = [(max(a, w0), min(b, w1), n) for k, n, a, b in events
              if k == "device" and b > w0 and a < w1]
    op_s, op_n = {}, {}
    for a, b, n in device:
        op_s[n] = op_s.get(n, 0.0) + (b - a) / 1e9
        op_n[n] = op_n.get(n, 0) + 1
    busy = _union([(a, b) for a, b, _ in device])
    spans = sorted((a, b, n) for k, n, a, b in events
                   if k == "span" and n != WINDOW_RANGE)
    host = sorted((a, b, n) for k, n, a, b in events if k == "host")
    span_starts = [s[0] for s in spans]
    host_starts = [h[0] for h in host]
    idle_s = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) // 2
        span = _host_at(spans, span_starts, mid) or "outside spans"
        if b - a < SHORT_GAP_NS:
            op = "gaps under 10 us"
        else:
            op = _host_at(host, host_starts, mid) or "no host op"
        label = f"{span.removeprefix('bench.')}: {op}"
        idle_s[label] = idle_s.get(label, 0.0) + (b - a) / 1e9
    return Summary(busy_s=sum(b - a for a, b in busy) / 1e9,
                   window_s=(w1 - w0) / 1e9, device_ops=len(device),
                   op_s=op_s, op_n=op_n, idle_s=idle_s)


def summarize(prof):
    """The Summary of a finished `torch.profiler.profile`, read from its
    raw events (no per-event Python objects are built)."""
    from torch.autograd import DeviceType

    events = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name.startswith("bench."):
            if e.device_type() == DeviceType.CUDA:
                continue          # the ranges' copies on the card's timeline
            kind = "span"
        elif e.device_type() == DeviceType.CUDA:
            kind = "device"
        else:
            kind = "host"
        events.append((kind, name, e.start_ns(), e.end_ns()))
    return reduce_events(events)


def top(d, k=10):
    """The k largest entries of {name: seconds} as [[name, seconds]]."""
    return [[n[:160], s] for n, s in sorted(d.items(), key=lambda x: -x[1])
            [:k]]
