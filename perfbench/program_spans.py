"""The program's own spans and counters in a traced run
(``bayesian_bm25_tpu_torch/utils/spans.py``), reduced to the ``program``
field of the trace record that the program-span metric readers read.

:class:`ProgramSpans` is made when the traced window starts: it turns
the program's spans on and notes its counters. The tracer tells it when
the profiled slice starts and stops, and it drains the spans when the
window ends. :meth:`ProgramSpans.reduce` gives:

- ``self_s``: self time (a span's wall less the part its children
  cover), seconds by span name, over the window's requests whose root
  span lies wholly outside the profiled slice, where the profiler does
  not slow the host; ``requests`` and ``queries`` count those requests;
- ``idle_s``: the slice's device-idle seconds by the innermost
  ``bb25: `` range open on the host at each gap's midpoint ("harness"
  where none is), the reduction ``Tracer.record`` makes over its own
  ``host: `` ranges;
- ``index_s``: the wall of each ``index*`` span, seconds (recorded only
  where spans were turned on before ``scorer.index``, see :func:`enable`);
- ``counters``: how far each of the program's counters moved over the
  window.

Against a program that has no spans module, :func:`enable` does nothing
and :meth:`ProgramSpans.reduce` returns None, so the readers report
nothing and nothing raises."""

from __future__ import annotations

import time

import torch

from perfbench import tracing

PREFIX = "bb25: "
PREP = ("encode", "split", "h2d")            # host work before the launches
STAGES = ("matmul", "leader_selection", "tf_transform", "score")


def is_stage(name: str) -> bool:
    """A span of one retrieval stage: those of STAGES and each merge pass."""
    return name in STAGES or name.startswith("merge.")


def _module():
    """The program's spans module, or None where the program has none."""
    try:
        from bayesian_bm25_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans


def enable():
    """Turn the program's spans on (before ``scorer.index``, so that the
    index spans are recorded); the module, or None."""
    spans = _module()
    if spans is not None:
        spans.enable()
    return spans


def is_range(name: str) -> bool:
    """A profiler range (the harness's or the program's), not device work."""
    return name.startswith((tracing.STAGE, tracing.HOST, tracing.SLICE,
                            PREFIX))


def self_seconds(spans: list) -> dict:
    """Span id -> its wall less the union of its children's, seconds."""
    kids: dict = {}
    for s in spans:
        if s["parent"] is not None:
            kids.setdefault(s["parent"], []).append((s["start"], s["end"]))
    out = {}
    for s in spans:
        lo, hi = s["start"], s["end"]
        inner = [(max(a, lo), min(b, hi)) for a, b in kids.get(s["id"], ())
                 if a < hi and b > lo]
        covered = sum(b - a for a, b in tracing.union(inner))
        out[s["id"]] = (hi - lo - covered) / 1e9
    return out


def outside_slice(spans: list, t0: int, slice_ns) -> dict:
    """Self seconds by span name over the requests that started at or
    after ``t0`` and whose root span misses ``slice_ns`` (start, end),
    with their number and queries; ``slice_ns`` None misses nothing."""
    roots = {s["id"]: s for s in spans
             if s["name"] == "request" and s["start"] >= t0}
    if slice_ns is not None:
        a, b = slice_ns
        roots = {r: s for r, s in roots.items()
                 if s["end"] <= a or s["start"] >= b}
    own = self_seconds(spans)
    self_s: dict = {}
    for s in spans:
        if s["request"] in roots:
            self_s[s["name"]] = self_s.get(s["name"], 0.0) + own[s["id"]]
    return dict(self_s=self_s, requests=len(roots),
                queries=sum(s["counts"].get("queries", 0)
                            for s in roots.values()))


def idle_by_range(events) -> dict:
    """Device-idle seconds inside the profiled slice, by the innermost
    program range open on the host at each gap's midpoint."""
    cpu = torch.autograd.DeviceType.CPU
    dev = torch.autograd.DeviceType.CUDA
    sl = [e for e in events if e.device_type == cpu
          and e.name == tracing.SLICE]
    if not sl:
        return {}
    lo, hi = sl[0].time_range.start, sl[0].time_range.end
    busy = tracing.union([
        (max(e.time_range.start, lo), min(e.time_range.end, hi))
        for e in events if e.device_type == dev and not is_range(e.name)
        and e.time_range.end > lo and e.time_range.start < hi])
    timeline = tracing.host_timeline([
        (e.time_range.start, e.time_range.end, e.name[len(PREFIX):])
        for e in events if e.device_type == cpu
        and e.name.startswith(PREFIX)])
    idle: dict = {}
    for s, e in tracing.idle_gaps(busy, lo, hi):
        name = tracing.label_at(timeline, (s + e) / 2)
        idle[name] = idle.get(name, 0.0) + (e - s) / 1e6
    return idle


class ProgramSpans:
    """The program's spans over one traced window: made at its start
    (spans on, counters noted), told of the profiled slice, drained at
    its end."""

    def __init__(self):
        self.spans = enable()
        self.t0 = time.perf_counter_ns()
        self.before = self.spans.counters() if self.spans else None
        self.slice_ns = None
        self.drained = None

    def slice_start(self) -> None:
        self.slice_ns = [time.perf_counter_ns(), None]

    def slice_stop(self) -> None:
        if self.slice_ns is not None:
            self.slice_ns[1] = time.perf_counter_ns()

    def finish(self) -> None:
        """Drain the spans; turn them off."""
        if self.spans is None:
            return
        self.drained = self.spans.drain()
        self.spans.disable()

    def reduce(self, events) -> dict | None:
        """The record's ``program`` field (module docstring), or None."""
        if self.drained is None:
            return None
        spans = self.drained["spans"]
        out = outside_slice(spans, self.t0, self.slice_ns)
        out["idle_s"] = idle_by_range(events) if events is not None else {}
        index_s: dict = {}
        for s in spans:
            if s["name"].startswith("index"):
                index_s[s["name"]] = (index_s.get(s["name"], 0.0)
                                      + (s["end"] - s["start"]) / 1e9)
        out["index_s"] = index_s
        out["counters"] = {k: v - self.before.get(k, 0)
                           for k, v in self.drained["counters"].items()}
        return out
