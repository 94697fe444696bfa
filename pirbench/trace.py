"""Reading a torch.profiler trace of a served window: the device's busy
time (the union of its kernel, copy and set intervals inside the window),
the time of the kernels by name, and the idle gaps by the host span the
benchmark was in when the card fell idle.
"""
from __future__ import annotations

import collections
import dataclasses

WINDOW = "pirbench.window"
# the benchmark's host spans around the calls into the program: parsing
# the query bytes, serving (the replay and the rows' fetch), packing the
# response bytes
SPANS = ("pirbench.parse", "pirbench.serve", "pirbench.pack")


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: dict          # name -> (launches, seconds)
    idle_by_span: dict     # host span -> idle seconds

    def kernel_time(self, fragment: str) -> tuple[int, float]:
        """Launches and seconds of the kernels whose name holds
        `fragment`."""
        n, s = 0, 0.0
        for name, (k, sec) in self.kernels.items():
            if fragment in name:
                n, s = n + k, s + sec
        return n, s

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:top]
        gaps = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:160], s] for n, (_, s) in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def summarize(events, device_type) -> TraceSummary:
    """events: the profiler's FunctionEvents; device_type: the DeviceType
    of the card's events.  Times in the trace are microseconds."""
    window = None
    spans = []
    device = []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        ours = e.name == WINDOW or e.name in SPANS
        if e.device_type == device_type:
            # the device timeline's copies of the host spans are no work
            if not ours:
                device.append((start, end, e.name))
        elif e.name == WINDOW:
            window = (start, end)
        elif ours:
            spans.append((start, end, e.name))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    w0, w1 = window
    device = sorted((max(s, w0), min(e, w1), n) for s, e, n in device
                    if e > w0 and s < w1)
    kernels = collections.defaultdict(lambda: [0, 0.0])
    busy, cover_end, gaps = 0.0, w0, []
    for s, e, name in device:
        k = kernels[name]
        k[0] += 1
        k[1] += (e - s) * 1e-6
        if s > cover_end:
            gaps.append((cover_end, s))
        if e > cover_end:
            busy += e - max(s, cover_end)
            cover_end = e
    if w1 > cover_end:
        gaps.append((cover_end, w1))
    spans.sort()
    idle = collections.defaultdict(float)
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        inner = [n for s, e, n in spans if s <= mid < e]
        idle[inner[-1] if inner else "pirbench.loop"] += (g1 - g0) * 1e-6
    return TraceSummary(window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6,
                        kernels={n: tuple(v) for n, v in kernels.items()},
                        idle_by_span=dict(idle))
