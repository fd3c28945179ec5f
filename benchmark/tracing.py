"""The benchmark's own instrumentation: spans on the host clock around its
calls into the program, two profiled sections over a short steady part of
the window (`--trace 1`), and the reading of their traces.

The first section records the device alone (CUDA activity, no host
ranges): the device's busy share, with the least overhead the profiler
can have. The second records host and device: the launches, the kernels
attributed to the propagation layers, the breakdown. Each section's trace
is read down to those numbers when it stops, and dropped. Units (steps,
requests) inside either section are left out of the host-clock metrics:
their spans go under `traced.<name>`, and the time and work they took are
kept apart.

Nothing here edits the program. The propagation layers are found in the
trace by what the benchmark wraps around the model object's
`propagate.apply`: a `bench.propagate.fwd` range around the call and,
while a section is traced and autograd records, marks whose backward runs
when the gradient reaches the layers' output (`bench.propagate.bwd_begin`)
and each of their weights (`bench.propagate.bwd_leaf`). A kernel belongs
to the layers when the host call that launched it lies inside such a range
on the same thread: attribution by launch, never by kernel name.
"""
from __future__ import annotations

import gc
import json
import os
import tempfile
import time
from collections import defaultdict
from contextlib import contextmanager

import torch

from .frozen import roofline

FWD = "bench.propagate.fwd"
BWD_BEGIN = "bench.propagate.bwd_begin"
BWD_LEAF = "bench.propagate.bwd_leaf"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Spans:
    """Host-clock intervals by name (perf_counter seconds), kept in
    memory; each is also a profiler range when a section is traced.
    While `tag` is set (a section runs), names take it as a prefix."""

    def __init__(self):
        self.intervals: dict[str, list] = defaultdict(list)
        self.tag = ""

    @contextmanager
    def span(self, name: str):
        key = self.tag + name
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench." + name):
            yield
        self.intervals[key].append((t0, time.perf_counter()))


class _Mark(torch.autograd.Function):
    """Identity whose backward leaves a zero-length profiler range."""

    @staticmethod
    def forward(ctx, name, x):
        ctx.name = name
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with torch.profiler.record_function(ctx.name):
            pass
        return None, g


def _mark_tree(tree, name):
    if isinstance(tree, dict):
        return {k: _mark_tree(v, name) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_mark_tree(v, name) for v in tree]
    if isinstance(tree, torch.Tensor) and tree.requires_grad:
        return _Mark.apply(name, tree)
    return tree


class PropagationProbe:
    """Wraps `model.propagate.apply` on the model object (not the class):
    the forward range always, the backward marks while `marking`."""

    def __init__(self, model):
        self.marking = False
        orig = model.propagate.apply

        def apply(params, h, *args, **kw):
            grad = self.marking and torch.is_grad_enabled()
            with torch.profiler.record_function(FWD):
                if grad:
                    params = _mark_tree(params, BWD_LEAF)
                out = orig(params, h, *args, **kw)
            if grad and out.requires_grad:
                out = _Mark.apply(BWD_BEGIN, out)
            return out

        model.propagate.apply = apply


class Section:
    """A profiled stretch of the window: synchronises, starts the profiler
    (CPU and CUDA activity, or with `device_only` CUDA activity alone), and
    on `stop` synchronises again, stops it and keeps the trace's events in
    memory (the exported file, written under the temporary directory, is
    deleted). `wall_s`: from the start's sync to the stop's."""

    def __init__(self, device, probe: PropagationProbe | None = None,
                 device_only: bool = False):
        self.device = device
        self.probe = probe
        self.device_only = device_only
        self.prof = None
        self.events = None
        self.wall_s = 0.0

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [] if self.device_only else [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        elif not acts:
            acts.append(ProfilerActivity.CPU)
        self.prof = profile(activities=acts)
        self.prof.start()
        if self.probe is not None:
            self.probe.marking = True
        self._t0 = time.perf_counter()

    def stop(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.wall_s = time.perf_counter() - self._t0
        if self.probe is not None:
            self.probe.marking = False
        self.prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.prof = None


class Tracer:
    """The traced stretch of a window: from unit `start` on, a
    device-only section of `units` units, then a host and device section of
    as many (`probe` marks the propagation layers in the second). The
    window calls `before(i)` ahead of unit i and `after(counts)` behind
    it; `counts` (a dict of numbers) is summed over the traced units.
    `wall_s`: the time from the first section's start to the end of the
    second's stop, its reading included."""

    def __init__(self, device, probe, spans: Spans, start: int, units: int):
        self.idle = Section(device, device_only=True)
        self.host = Section(device, probe)
        self.spans = spans
        self.start, self.units = start, units
        self.active: Section | None = None
        self.done = False
        self.n = 0
        self.counts: dict = defaultdict(float)
        self.readings: dict = {}
        self.wall_s = 0.0

    def _begin(self, section: Section):
        self.active, self.n = section, 0
        self.spans.tag = "traced."
        section.start()

    def before(self, i: int) -> None:
        if not self.done and self.active is None and i == self.start:
            self._t0 = time.perf_counter()
            self._begin(self.idle)

    def after(self, counts: dict) -> None:
        if self.active is None:
            return
        for k, v in counts.items():
            self.counts[k] += v
        self.n += 1
        if self.n < self.units:
            return
        section = self.active
        section.stop()
        if section is self.idle:
            self.readings["idle_summary"] = section_summary(section,
                                                            host_wall=True)
        else:
            us = propagation_kernel_us(section.events)
            self.readings.update(
                section_summary=section_summary(section),
                breakdown=breakdown(section.events),
                prop_kernel_s=None if us is None else us / 1e6)
        # the trace's objects go now, not in a collection inside the
        # window's timed units
        section.events = None
        gc.collect()
        if section is self.idle:
            self._begin(self.host)
            return
        self.active, self.done = None, True
        self.spans.tag = ""
        self.wall_s = time.perf_counter() - self._t0

    @property
    def running(self) -> bool:
        return self.active is not None

    def record(self, rec: dict) -> None:
        """The traced stretch's part of a window's record: the time and
        counts of its units (`traced_s`, `traced`) and, once both sections
        ran, their readings: `idle_summary` (the device-only section),
        `section_summary`, `breakdown` and `prop_kernel_s` (the host and
        device one) and `section_units`."""
        rec["traced_s"] = self.wall_s
        rec["traced"] = dict(self.counts)
        if self.done:
            rec.update(self.readings, section_units=self.units)


def warm_profiler(device) -> None:
    """One empty profiled interval, so that the profiler's first start (the
    tracing library's initialisation) lands in set-up, not in the
    window."""
    s = Section(device)
    s.start()
    torch.zeros(1, device=device).add_(1)
    s.stop()


def _timed(events):
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def propagation_kernel_us(events: list) -> float | None:
    """Device us of the kernels launched inside the propagation ranges
    (forward ranges, and backward stretches from a `bwd_begin` mark to the
    last `bwd_leaf` mark before the next `bwd_begin` on that thread); None
    when the section holds no propagation range."""
    timed = _timed(events)
    by_tid: dict = defaultdict(list)
    for e in timed:
        if e["name"] == FWD:
            by_tid[e["tid"]].append((e["ts"], e["ts"] + e["dur"]))
    marks: dict = defaultdict(list)
    for e in timed:
        if e["name"] in (BWD_BEGIN, BWD_LEAF):
            marks[e["tid"]].append((e["ts"], e["name"]))
    for tid, ms in marks.items():
        ms.sort()
        start = last = None
        for ts, name in ms + [(float("inf"), BWD_BEGIN)]:
            if name == BWD_BEGIN:
                if start is not None and last is not None:
                    by_tid[tid].append((start, last))
                start, last = ts, None
            elif start is not None:
                last = ts
    if not by_tid:
        return None
    corr = set()
    for e in timed:
        if e.get("cat") not in LAUNCH_CATS:
            continue
        c = (e.get("args") or {}).get("correlation")
        if c is None:
            continue
        t = e["ts"]
        if any(a <= t <= b for a, b in by_tid.get(e["tid"], ())):
            corr.add(c)
    total = sum(e["dur"] for e in timed if e.get("cat") == "kernel"
                and (e.get("args") or {}).get("correlation") in corr)
    return total


def breakdown(events: list) -> dict:
    """The device operations that took most time and the longest idle gaps
    of the device, each named by the host activity at its middle (the
    outermost `bench.` range and the innermost host operation there, on
    any thread)."""
    split = roofline.trace_split(events) or {"top_device_ops": []}
    ops = [[o["name"], o["ms"] / 1e3] for o in split["top_device_ops"]]
    timed = _timed(events)
    kernels = roofline.kernel_intervals(timed)
    gaps, end = [], None
    for a, b, _ in kernels:
        if end is not None and a > end:
            gaps.append((a - end, end, a))
        end = b if end is None else max(end, b)
    gaps.sort(reverse=True)
    host = [e for e in timed if e.get("cat") in ("cpu_op", "user_annotation",
                                                 "python_function")]
    named = []
    for length, a, b in gaps[:10]:
        mid = (a + b) / 2
        over = [e for e in host if e["ts"] <= mid <= e["ts"] + e["dur"]]
        bench = [e for e in over if e["name"].startswith("bench.")]
        outer = max(bench, key=lambda e: e["dur"])["name"] if bench else "-"
        inner = min(over, key=lambda e: e["dur"])["name"] if over else "idle"
        named.append([f"{outer} | {inner}", length / 1e6])
    return {"device_ops": ops, "idle_gaps": named}


def section_summary(section: Section, host_wall: bool = False) -> dict:
    """busy and wall seconds, launches and the split of one section. The
    wall is the span of the trace's events, or with `host_wall` the
    section's own, from sync to sync (a device-only trace holds no host
    events to span)."""
    split = roofline.trace_split(section.events)
    if split is None:
        return {"busy_s": 0.0, "window_s": section.wall_s, "launches": 0,
                "split": None}
    return {"busy_s": split["device_busy_ms"] / 1e3,
            "window_s": (section.wall_s if host_wall
                         else split["wall_ms"] / 1e3),
            "launches": split["kernel_launches"], "split": split}
