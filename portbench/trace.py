"""Reduce a torch.profiler trace of the traced sub-window.

``Trace`` holds the device operations (kernels, copies, sets) with their
times, the host operations and spans (``portbench.*`` around the calls
into the engine), and the steps the sub-window ran with their positions.
Per-layer readers take their numbers from it; ``breakdown`` gives the
device operations that took the most time and the idle gaps by what the
host was doing.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

Interval = Tuple[float, float]              # seconds, start and end
#: the prefix of the benchmark's own spans
SPAN = "portbench."
#: host operations looked back through for one covering a gap's start
_WALK = 256


@dataclass
class DeviceOp:
    name: str
    start: float
    end: float

    @property
    def seconds(self) -> float:
        return self.end - self.start


@dataclass
class Trace:
    device_ops: List[DeviceOp]
    host_ops: List[DeviceOp]
    window: Interval                        # the traced sub-window
    step_pos: List[int] = field(default_factory=list)
    batch: int = 0

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def steps(self) -> int:
        return len(self.step_pos)

    def busy_intervals(self) -> List[Interval]:
        """The union of the device operations' intervals, in the window."""
        lo, hi = self.window
        spans = sorted((max(lo, o.start), min(hi, o.end))
                       for o in self.device_ops if o.end > lo and o.start < hi)
        out: List[Interval] = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def named(self, *parts: str) -> List[DeviceOp]:
        return [o for o in self.device_ops
                if any(p in o.name for p in parts)]

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """Each idle stretch of the window, named by the innermost host
        operation running at its start, or else by the benchmark's span
        around it (the host then runs Python between operations)."""
        busy = self.busy_intervals()
        lo, hi = self.window
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        spans = [o for o in self.host_ops if o.name.startswith(SPAN)]
        ops = sorted((o for o in self.host_ops
                      if not o.name.startswith(SPAN)), key=lambda o: o.start)
        starts = [o.start for o in ops]
        out = []
        for s, e in gaps:
            name = None
            i = bisect.bisect_right(starts, s) - 1
            for j in range(i, max(-1, i - _WALK), -1):
                if ops[j].end >= s:
                    name = ops[j].name
                    break
            if name is None:
                around = [o for o in spans if o.start <= s <= o.end]
                name = (max(around, key=lambda o: o.start).name + " (Python)"
                        if around else "(between the benchmark's spans)")
            out.append((name, e - s))
        return out

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        ops: Dict[str, float] = {}
        for o in self.device_ops:
            ops[o.name] = ops.get(o.name, 0.0) + o.seconds
        gaps: Dict[str, float] = {}
        for name, s in self.idle_gaps():
            gaps[name] = gaps.get(name, 0.0) + s
        rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]  # noqa
        return {"device_ops": [[k, v] for k, v in rank(ops)],
                "idle_gaps": [[k, v] for k, v in rank(gaps)]}


def from_profiler(prof, step_pos: List[int], batch: int) -> Trace:
    """A Trace from a finished ``torch.profiler.profile`` whose steps ran
    inside the benchmark's spans: the window runs from the first span's
    start to the last one's end, on the profiler's clock."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        op = DeviceOp(e.name, tr.start * 1e-6, tr.end * 1e-6)
        if e.device_type == DeviceType.CUDA:
            if not e.name.startswith(SPAN):   # a span's copy on the device
                dev.append(op)
        elif e.device_type == DeviceType.CPU:
            host.append(op)
    spans = [o for o in host if o.name.startswith(SPAN)]
    if not spans:
        raise RuntimeError("the profiler recorded none of the benchmark's "
                           "spans")
    window = (min(o.start for o in spans), max(o.end for o in spans))
    return Trace(dev, host, window, list(step_pos), batch)
