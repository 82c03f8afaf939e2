"""torch.profiler around a run of requests, reduced to what the per-layer
metrics read.

The profiler's Chrome trace is written to a file under the run's TMPDIR,
read back and deleted. Kept: device kernels, copies and memsets (device,
start, duration, correlation id), the host's launch calls (correlation id
-> start), the spans (record_function: the harness's one around each
request, the program's own inside it) and the host's operators on the
issuing thread, each in microseconds on one clock.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field

REQUEST_SPAN = "gpubench.request"


@dataclass
class Event:
    name: str
    device: int
    ts: float
    dur: float
    corr: int = -1
    tid: object = None

    @property
    def end(self) -> float:
        return self.ts + self.dur


@dataclass
class Trace:
    kernels: list = field(default_factory=list)
    copies: list = field(default_factory=list)
    memsets: list = field(default_factory=list)
    launches: dict = field(default_factory=dict)  # correlation id -> host start
    spans: list = field(default_factory=list)
    host: list = field(default_factory=list)

    def requests(self) -> list:
        return [s for s in self.spans if s.name == REQUEST_SPAN]

    def window(self) -> tuple[float, float]:
        req = self.requests()
        return min(s.ts for s in req), max(s.end for s in req)

    def devices(self) -> list:
        return sorted({e.device for e in self.kernels + self.copies})

    def busy_intervals(self, device) -> list:
        """Merged [start, end) intervals in which the device ran a kernel,
        a copy or a memset, clipped to the window."""
        t0, t1 = self.window()
        spans = sorted((max(e.ts, t0), min(e.end, t1))
                       for e in self.kernels + self.copies + self.memsets
                       if e.device == device and e.end > t0 and e.ts < t1)
        merged = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_us(self, device) -> float:
        return sum(b - a for a, b in self.busy_intervals(device))

    def launched_in(self, span_name: str) -> list:
        """Kernels whose host launch lies inside a span of that name."""
        spans = sorted((s.ts, s.end) for s in self.spans if s.name == span_name)
        starts = [a for a, _ in spans]
        out = []
        for k in self.kernels:
            t = self.launches.get(k.corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                out.append(k)
        return out


def short_name(name: str, width: int = 96) -> str:
    """A kernel's or operator's name without a trailing argument list, cut
    to `width`."""
    n = name.removeprefix("void ").strip()
    if n.endswith(")") and not n.startswith(("Memcpy", "Memset")):
        depth = 0
        for i in range(len(n) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(n[i], 0)
            if depth == 0:
                n = n[:i].rstrip() or n
                break
    return n if len(n) <= width else n[: width - 3] + "..."


def read_chrome_trace(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    tr = Trace()
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat", ""), e.get("args", {}) or {}
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        corr = int(args.get("correlation", -1))
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            ev = Event(e["name"], int(args.get("device", e.get("pid", 0))), ts, dur, corr)
            kind = {"kernel": tr.kernels, "gpu_memcpy": tr.copies, "gpu_memset": tr.memsets}
            kind[cat].append(ev)
        elif cat in ("cuda_runtime", "cuda_driver"):
            if corr >= 0:
                tr.launches[corr] = ts
            tr.host.append(Event(e["name"], -1, ts, dur, corr, e.get("tid")))
        elif cat == "user_annotation":
            tr.spans.append(Event(e["name"], -1, ts, dur, -1, e.get("tid")))
        elif cat == "cpu_op":
            tr.host.append(Event(e["name"], -1, ts, dur, -1, e.get("tid")))
    return tr


def profile(calls):
    """Run `calls()` under torch.profiler (host and CUDA); the stopped
    profiler, to be read once the window has closed (`read`)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        calls()
    return prof


def read(prof) -> Trace:
    fd, path = tempfile.mkstemp(suffix=".json", prefix="gpubench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return read_chrome_trace(path)
    finally:
        os.unlink(path)


def breakdown(tr: Trace) -> dict:
    """The device operations that took most time in the window, and the
    device's idle time by what the issuing thread was doing (the innermost
    host event over each idle gap's midpoint), ten of each, in seconds;
    idle time is summed over the cards."""
    t0, t1 = tr.window()
    ops = defaultdict(float)
    for e in tr.kernels + tr.copies + tr.memsets:
        if e.end > t0 and e.ts < t1:
            ops[short_name(e.name)] += (min(e.end, t1) - max(e.ts, t0)) * 1e-6
    req_tid = tr.requests()[0].tid
    host = sorted((h for h in tr.host + tr.spans if h.tid == req_tid),
                  key=lambda h: (h.ts, -h.dur))
    gaps = []
    for dev in tr.devices():
        edges = [t0] + [x for ab in tr.busy_intervals(dev) for x in ab] + [t1]
        gaps += [(0.5 * (a + b), b - a) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    # The host's events on one thread nest: sweep the gaps' midpoints in
    # order, keeping the stack of events open at each.
    idle, stack, j = defaultdict(float), [], 0
    for mid, length in sorted(gaps):
        while j < len(host) and host[j].ts <= mid:
            while stack and stack[-1].end <= host[j].ts:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1].end < mid:
            stack.pop()
        label = stack[-1].name if stack else "host, outside any span"
        idle[short_name(label)] += length * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(ops), "idle_gaps": top(idle)}
