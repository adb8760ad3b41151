"""The traced run: host spans and stage ranges from the benchmark's own
wrappers around calls into the program, a profiler slice of the
window, and its reduction to the record that the per-layer metric
readers (``perfbench/metrics/<name>.py``) read.

``staged``, ``kernel_bucket`` and ``stage_device_ms`` are copied from
``chip_smoke.py`` (its profiler ranges around the split path's stages),
so the yardstick stays fixed while the program changes."""

from __future__ import annotations

import bisect
import time

import numpy as np
import torch
from torch.profiler import record_function

STAGE = "stage: "
HOST = "host: "
SLICE = "perfbench: slice"


def merge_kind(kw) -> str:
    """The pass a split_index._sparse_merge call makes, from its keyword
    arguments: "tier-2" (group B's postings2), "heavy" (the heavy rows'
    base_tail_tf) or "tier-1"."""
    if kw.get("postings2") is not None:
        return "tier-2"
    return "heavy" if kw.get("base_tail_tf") is not None else "tier-1"


def staged(sidx, on_call=None):
    """Wrap the split path's stages in profiler ranges: the frequent-term
    matmul (the unfused product or K4), leader selection (blockwise with
    K1, or from K4's maxima), each merge pass by kind, and tf at the
    winners with the transform ("tf + transform"). ``on_call(fn, label,
    args, kwargs)``, if given, sees each outermost stage call. Returns a
    function that restores the originals."""
    from bayesian_bm25_tpu_torch.engine import cuda_matmul
    from bayesian_bm25_tpu_torch.ops import transform as T

    orig = (sidx._impact_matmul, sidx.exact_topk_blockwise, sidx._sparse_merge,
            cuda_matmul.impact_matmul_bmax, sidx._topk_from_bmax,
            sidx._winner_tf_freq, T.score_to_probability)
    depth = [0]

    def wrap(fn, name):
        def run(*a, **kw):
            label = name(kw) if callable(name) else name
            if on_call is not None and depth[0] == 0:
                on_call(fn, label, a, kw)
            depth[0] += 1
            try:
                with record_function(STAGE + label):
                    return fn(*a, **kw)
            finally:
                depth[0] -= 1
        return run

    sidx._impact_matmul = wrap(orig[0], "matmul")
    sidx.exact_topk_blockwise = wrap(orig[1], "leader selection")
    sidx._sparse_merge = wrap(orig[2], lambda kw: "merge " + merge_kind(kw))
    cuda_matmul.impact_matmul_bmax = wrap(orig[3], "matmul")
    sidx._topk_from_bmax = wrap(orig[4], "leader selection")
    sidx._winner_tf_freq = wrap(orig[5], "tf + transform")
    T.score_to_probability = wrap(orig[6], "tf + transform")

    def restore():
        (sidx._impact_matmul, sidx.exact_topk_blockwise, sidx._sparse_merge,
         cuda_matmul.impact_matmul_bmax, sidx._topk_from_bmax,
         sidx._winner_tf_freq, T.score_to_probability) = orig
    return restore


def kernel_bucket(name: str) -> str:
    if any(k in name for k in ("impact_matmul", "compact_kernel",
                               "int8_kernel", "bf16_kernel")):
        return "K4 impact_matmul_bmax"
    if "bm25_hash_kernel" in name or "bm25_scan_kernel" in name:
        return "K5 bm25_compare"
    if "row_gather" in name:
        return "K2 row_gather"
    if "topk" in name:
        return "K3 topk"
    if "block_max" in name:
        return "K1 block_max"
    if "sort" in name.lower():
        return "sort"
    if "gemm" in name.lower() or "cutlass" in name.lower():
        return "gemm"
    if "memcpy" in name.lower():
        return "memcpy"
    if "memset" in name.lower():
        return "memset"
    return "other"


def _is_range(name: str) -> bool:
    return name.startswith((STAGE, HOST, SLICE))


def stage_device_ms(events) -> tuple[dict, dict]:
    """Device ms by kernel bucket of each ``staged`` range in a profiler's
    events, with the range's count under "calls", and of the device
    events outside every range. A device event belongs to the range
    whose CPU span holds the runtime call that launched it (the two share
    a correlation id); one whose call was not traced, to the range's
    span on the device that holds its start."""
    cpu, dev = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def spans(device_type):
        return sorted((e.time_range.start, e.time_range.end,
                       e.name[len(STAGE):]) for e in events
                      if e.device_type == device_type
                      and e.name.startswith(STAGE))

    def holding(sp, starts, t):
        j = bisect.bisect_right(starts, t) - 1
        return sp[j][2] if j >= 0 and t < sp[j][1] else None

    on_cpu, on_dev = spans(cpu), spans(dev)
    cpu_starts = [x[0] for x in on_cpu]
    dev_starts = [x[0] for x in on_dev]
    launched = {e.id: e.time_range.start for e in events
                if e.device_type == cpu and e.name.startswith("cu")}
    stages: dict[str, dict[str, float]] = {}
    for _, _, name in on_cpu:
        d = stages.setdefault(name, {})
        d["calls"] = d.get("calls", 0) + 1
    rest: dict[str, float] = {}
    for e in events:
        if e.device_type != dev or _is_range(e.name):
            continue
        t = launched.get(e.id)
        name = (holding(on_cpu, cpu_starts, t) if t is not None
                else holding(on_dev, dev_starts, e.time_range.start))
        d = rest if name is None else stages.setdefault(name, {})
        b = kernel_bucket(e.name)
        d[b] = d.get(b, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    return stages, rest


def union(intervals: list) -> list:
    """Merged, sorted (start, end) intervals."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def idle_gaps(busy: list, lo: float, hi: float) -> list:
    """(start, end) of the device's idle gaps inside [lo, hi]."""
    gaps, t = [], lo
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def host_timeline(spans: list) -> tuple[list, list]:
    """Nested (start, end, name) host spans flattened into (starts,
    names) segments, each named by its innermost span ("harness" where
    none runs)."""
    edges = sorted([(s, 1, i) for i, (s, _, _) in enumerate(spans)]
                   + [(e, 0, i) for i, (_, e, _) in enumerate(spans)])
    starts, names, stack = [], [], []
    for t, opening, i in edges:
        if opening:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
        starts.append(t)
        names.append(spans[stack[-1]][2] if stack else "harness")
    return starts, names


def label_at(timeline: tuple, t: float) -> str:
    starts, names = timeline
    j = bisect.bisect_right(starts, t) - 1
    return names[j] if j >= 0 else "harness"


class Tracer:
    """Host spans around the program's launch, encode and pull, and one
    profiler slice of ``n_requests`` requests, started at the first
    request handed ``start_after`` seconds into the window. Launch time
    is read outside the slice, where the profiler does not slow it."""

    def __init__(self, scorer, traffic, seconds: float, device):
        from bayesian_bm25_tpu_torch.engine import split_index as sidx
        from bayesian_bm25_tpu_torch.models import scorer as scorer_mod

        self.scorer, self.sidx, self.mod = scorer, sidx, scorer_mod
        self.n_requests = int(traffic["trace_requests"])
        self.start_after = float(seconds) / 3.0
        self.cuda = torch.device(device).type == "cuda"
        self.t_first = None
        self.first = None         # first request of the slice
        self.current = -1
        self.prof = None
        self._stopped = None
        self.events = None
        self.launches: list = []  # (request, queries, seconds)
        self.nnz: list = []       # nonzero frequent counts per encode
        self.matmuls: list = []   # (storage, nq, K, D_pad) per product
        self._undo = []
        self._restore_stages = None

    # -- wrappers --------------------------------------------------------
    def install(self) -> None:
        """Wrap the program's launch, encode and pull, and start the
        profiler once on a trivial op, so that its first start (CUPTI's
        set-up, a second or more) falls in set-up, not in the window."""
        from torch.profiler import profile

        warm = profile(activities=self._activities())
        warm.start()
        x = torch.ones(8, device="cuda" if self.cuda else "cpu").sum()
        if self.cuda:
            torch.cuda.synchronize()
        warm.stop()
        del x, warm
        sc, sidx, mod = self.scorer, self.sidx, self.mod
        launch, encode, pull = sc._retrieve_launch, sidx.encode_queries_split, mod._pull

        def t_launch(query_tokens, *a, **kw):
            t0 = time.perf_counter()
            with record_function(HOST + "launch"):
                out = launch(query_tokens, *a, **kw)
            self.launches.append((self.current, len(query_tokens),
                                  time.perf_counter() - t0))
            return out

        def t_encode(*a, **kw):
            with record_function(HOST + "encode"):
                out = encode(*a, **kw)
            if self.prof is not None:
                self.nnz.append(int(np.count_nonzero(np.asarray(out[1]) > 0)))
            return out

        def t_pull(*a, **kw):
            with record_function(HOST + "pull"):
                return pull(*a, **kw)

        sc._retrieve_launch = t_launch
        sidx.encode_queries_split = t_encode
        mod._pull = t_pull
        self._undo = [lambda: delattr(sc, "_retrieve_launch"),
                      lambda: setattr(sidx, "encode_queries_split", encode),
                      lambda: setattr(mod, "_pull", pull)]

    def uninstall(self) -> None:
        for f in self._undo:
            f()
        self._undo = []

    def _on_stage(self, fn, label, args, kwargs) -> None:
        """The frequent-term product's storage and shapes, for its
        roofline: K4 takes (q, hi_t, lo_t, scale, n_docs), column-major;
        the unfused product (q, impact, impact_lo, scale=, coarse=)."""
        if label != "matmul":
            return
        q = args[0]
        if fn.__name__ == "impact_matmul_bmax":
            hi, lo, scale = args[1], args[2], args[3]
            d_pad, coarse = hi.shape[1], False
        else:
            hi = args[1]
            lo = args[2] if len(args) > 2 else kwargs.get("impact_lo")
            scale = args[3] if len(args) > 3 else kwargs.get("scale")
            d_pad, coarse = hi.shape[0], kwargs.get("coarse", False)
        if scale is not None:
            storage = "int8-coarse" if coarse else "int8"
        elif lo is not None:
            storage = "hilo"
        else:
            storage = "bf16" if hi.dtype == torch.bfloat16 else "f32"
        self.matmuls.append((storage, q.shape[0], q.shape[1], d_pad))

    # -- the slice -------------------------------------------------------
    def tick(self, i: int) -> None:
        """Called before request ``i`` is handed."""
        self.current = i
        now = time.perf_counter()
        if self.t_first is None:
            self.t_first = now
        if self.prof is None and self.first is None \
                and now - self.t_first >= self.start_after:
            self._start(i)
        elif self.prof is not None and i >= self.first + self.n_requests:
            self._stop()

    def _activities(self) -> list:
        from torch.profiler import ProfilerActivity

        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        return acts

    def _start(self, i: int) -> None:
        from torch.profiler import profile

        self.first = i
        self.prof = profile(activities=self._activities())
        self.prof.start()
        self._slice = record_function(SLICE)
        self._slice.__enter__()
        self._restore_stages = staged(self.sidx, self._on_stage)

    def _stop(self) -> None:
        self._restore_stages()
        self._slice.__exit__(None, None, None)
        self.prof.stop()
        self._stopped, self.prof = self.prof, None

    def finish(self) -> None:
        """After the window: stop a slice still open, and read the trace
        (seconds at 1M documents, so never inside the window)."""
        if self.prof is not None:
            self._stop()
        self.uninstall()
        if self._stopped is not None:
            self.events = self._stopped.events()
            self._stopped = None

    def in_slice(self, r: int) -> bool:
        return self.first is not None and \
            self.first <= r < self.first + self.n_requests

    # -- reduction -------------------------------------------------------
    def record(self, window) -> dict | None:
        """The traced slice reduced for the metric readers, or None when
        no slice was taken."""
        if self.events is None:
            return None
        from perfbench import roofline

        cpu = torch.autograd.DeviceType.CPU
        dev = torch.autograd.DeviceType.CUDA
        ev = self.events
        sl = [e for e in ev if e.device_type == cpu and e.name == SLICE]
        lo, hi = sl[0].time_range.start, sl[0].time_range.end
        kernels = [(e.time_range.start, e.time_range.end) for e in ev
                   if e.device_type == dev and not _is_range(e.name)
                   and e.time_range.end > lo and e.time_range.start < hi]
        busy = union([(max(s, lo), min(e, hi)) for s, e in kernels])
        busy_us = sum(e - s for s, e in busy)
        timeline = host_timeline([
            (e.time_range.start, e.time_range.end, e.name[len(HOST):])
            for e in ev if e.device_type == cpu and e.name.startswith(HOST)])
        gaps: dict[str, float] = {}
        longest: dict[str, float] = {}
        for s, e in idle_gaps(busy, lo, hi):
            name = label_at(timeline, (s + e) / 2)
            gaps[name] = gaps.get(name, 0.0) + (e - s) / 1e6
            longest[name] = max(longest.get(name, 0.0), (e - s) / 1e6)
        stages, rest = stage_device_ms(ev) if self.cuda else ({}, {})
        ops: dict[str, float] = {}
        for st, d in list(stages.items()) + [("outside", rest)]:
            for b, ms in d.items():
                if b != "calls":
                    ops[f"{st}: {b}"] = ops.get(f"{st}: {b}", 0.0) + ms / 1e3
        reqs = [r for r in range(len(window.sizes)) if self.in_slice(r)]
        out_launch = [(r, q, s) for r, q, s in self.launches
                      if not self.in_slice(r) and r >= 0]
        out_reqs = {r for r, _, _ in out_launch}
        matmul_bound_ms = None
        peaks = roofline.peaks(torch.cuda.get_device_name(0)
                               if self.cuda else "")
        if peaks is not None and self.matmuls \
                and len(self.nnz) >= len(self.matmuls):
            matmul_bound_ms = sum(
                roofline.matmul_bound_ms(nq, K, d_pad, storage, nnz, peaks)
                for (storage, nq, K, d_pad), nnz in zip(self.matmuls,
                                                        self.nnz))
        return dict(
            slice_s=(hi - lo) / 1e6,
            busy_s=busy_us / 1e6,
            device_events=len(kernels),
            requests=len(reqs),
            queries=sum(window.sizes[r] for r in reqs),
            stages=stages,
            outside=rest,
            matmul_bound_ms=matmul_bound_ms,
            launch_s=sum(s for _, _, s in out_launch),
            launch_queries=sum(q for _, q, _ in out_launch),
            launch_requests=len(out_reqs),
            device_ops=sorted(ops.items(), key=lambda x: -x[1])[:10],
            idle_gaps=(sorted(gaps.items(), key=lambda x: -x[1])
                       + sorted(((f"{n} longest", v) for n, v in
                                 longest.items()), key=lambda x: -x[1])
                       )[:10],
        )
