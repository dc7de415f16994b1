"""The device trace of a `--trace 1` run, reduced to what the metric
readers and the result's `breakdown` need.

`torch.profiler` records CPU ops and, through CUPTI, every kernel,
copy and fill on the card.  The traced window is the benchmark's own
`bench.window` span; every device interval is clipped to it.  Busy
seconds are the union of the device intervals (kernels on several
streams overlap, so a sum would count twice); an idle gap is a stretch
of the window with no device interval, named by the innermost host op
in progress at its middle.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

WINDOW_SPAN = "bench.window"


@dataclass
class Trace:
    """Device intervals [(start_s, end_s, name)] clipped to the window,
    host ops [(start_s, end_s, name)], the window's bounds (seconds on
    the trace's clock)."""
    device: List[Tuple[float, float, str]]
    host: List[Tuple[float, float, str]]
    start: float
    end: float
    _union: Optional[List[Tuple[float, float]]] = field(default=None,
                                                        repr=False)

    @property
    def window_s(self) -> float:
        return self.end - self.start

    def union(self) -> List[Tuple[float, float]]:
        """The device intervals merged where they overlap."""
        if self._union is None:
            merged: List[List[float]] = []
            for s, e, _ in sorted(self.device):
                if merged and s <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], e)
                else:
                    merged.append([s, e])
            self._union = [(s, e) for s, e in merged]
        return self._union

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.union())

    def kernels(self, *names: str) -> List[Tuple[float, float, str]]:
        """Device intervals whose name contains any of `names`."""
        return [ev for ev in self.device if any(n in ev[2] for n in names)]

    def seconds(self, *names: str) -> float:
        """Device seconds of the intervals named by any of `names`,
        merged where they overlap."""
        merged, total = None, 0.0
        for s, e, _ in sorted(self.kernels(*names)):
            if merged is not None and s <= merged[1]:
                merged[1] = max(merged[1], e)
                continue
            if merged is not None:
                total += merged[1] - merged[0]
            merged = [s, e]
        return total + (merged[1] - merged[0] if merged else 0.0)

    def alone_s(self, *names: str) -> float:
        """Seconds in which an interval named by any of `names` runs and
        no other device interval does."""
        def union(evs):
            merged: List[List[float]] = []
            for s, e, _ in sorted(evs):
                if merged and s <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], e)
                else:
                    merged.append([s, e])
            return merged

        named = self.kernels(*names)
        skip = set(named)
        others = union([ev for ev in self.device if ev not in skip])
        total, j = 0.0, 0
        for s, e in union(named):
            alone = e - s
            while j < len(others) and others[j][1] <= s:
                j += 1
            k = j
            while k < len(others) and others[k][0] < e:
                alone -= min(e, others[k][1]) - max(s, others[k][0])
                k += 1
            total += alone
        return total

    def idle_gaps(self) -> List[Tuple[float, float]]:
        gaps, cursor = [], self.start
        for s, e in self.union():
            if s > cursor:
                gaps.append((cursor, s))
            cursor = max(cursor, e)
        if self.end > cursor:
            gaps.append((cursor, self.end))
        return gaps

    def host_ops_at(self, times: List[float]) -> List[str]:
        """The innermost (shortest) host op in progress at each of
        `times`."""
        import numpy as np

        if not self.host:
            return ["no host op"] * len(times)
        starts = np.array([h[0] for h in self.host])
        ends = np.array([h[1] for h in self.host])
        names = [h[2] for h in self.host]
        out = []
        for t in times:
            inside = np.flatnonzero((starts <= t) & (ends >= t))
            out.append(names[inside[np.argmin(ends[inside] - starts[inside])]]
                       if inside.size else "no host op")
        return out

    def breakdown(self, top: int = 10, gaps_named: int = 1000) -> dict:
        """The device ops that took the most seconds, and the idle
        gaps by the host op in progress at their middle: the
        `gaps_named` longest gaps, summed by that op's name."""
        by_op: Dict[str, float] = {}
        for s, e, name in self.device:
            by_op[name[:160]] = by_op.get(name[:160], 0.0) + (e - s)
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        longest = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])
        longest = longest[:gaps_named]
        gaps: Dict[str, float] = {}
        named = self.host_ops_at([(s + e) / 2 for s, e in longest])
        for (s, e), name in zip(longest, named):
            gaps[name[:160]] = gaps.get(name[:160], 0.0) + (e - s)
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in idle]}


class TraceWindow:
    """The profiler around a run's traced window: `start()` ahead of the
    window (the profiler's own start, seconds long on a card, stays out
    of it), `open()` at the window's start, `close()` at its end, which
    stops the profiler.  `.trace` is the reduced `Trace`, worked out on
    first use (after the measured window).  Does nothing when not
    `enabled`."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.closed = False
        self._prof = self._span = self._trace = None

    def start(self) -> None:
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()

    def open(self) -> None:
        if self.enabled:
            import torch
            self._span = torch.profiler.record_function(WINDOW_SPAN)
            self._span.__enter__()

    def close(self) -> None:
        if not self.enabled or self.closed:
            return
        self._span.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self.closed = True

    @property
    def trace(self) -> Optional[Trace]:
        if self._trace is None and self.closed:
            self._trace = reduce(self._prof.profiler.kineto_results.events())
            self._prof = None
        return self._trace


def reduce(events) -> Trace:
    """Kineto events -> `Trace`: device events (kernels, copies, fills)
    and host ops, clipped to the `bench.window` span.  Host annotations
    (record_function ranges such as the optimizer's step) are copied
    onto the device's timeline; those copies are not device work."""
    events = list(events)
    annotations = {ev.name() for ev in events if ev.is_user_annotation()}
    device, host, start, end = [], [], None, None
    for ev in events:
        s = ev.start_ns() * 1e-9
        e = s + ev.duration_ns() * 1e-9
        name = ev.name()
        if str(ev.device_type()).endswith("CUDA"):
            if not ev.is_user_annotation() and name not in annotations:
                device.append((s, e, name))
        elif name == WINDOW_SPAN:
            start, end = s, e
        else:
            host.append((s, e, name))
    if start is None:
        raise RuntimeError("trace: no bench.window span was recorded")
    clipped = [(max(s, start), min(e, end), n) for s, e, n in device
               if e > start and s < end]
    return Trace(clipped, [h for h in host if h[1] > start and h[0] < end],
                 start, end)
