"""Spans and counters of the retrieval path and of ``index()``.

Spans are off until :func:`enable`. While off, :func:`span` and
:func:`request` return :data:`NULL`, one shared context that does
nothing, after one flag check: no allocation, no profiler range, no CUDA
event. While on, each span records its name, its start and end
(``time.perf_counter_ns``), its id, its parent's id, the id of the
request it belongs to (a root span's own id) and a small dict of counts,
into an in-memory store of at most :data:`CAP` spans (those beyond it
are counted in ``spans_dropped``). When a ``torch.profiler`` session is
active, each span but a request's also opens a
``record_function("bb25: <name>")`` range, so that it sits on the
profiler's timeline beside the kernels it launched (requests overlap in
a stream, and a profiler range has to close in the order it opened). :func:`drain` hands the stored spans to the caller; nothing is
written anywhere.

A request is one call to ``retrieve``, or one batch of ``retrieve_many``
or ``retrieve_stream``: its root span runs from its first launch to the
end of the copy that brings its answers to the host, and every span
opened under it shares its request id.

The counters in :data:`counts` are plain integer adds and always on:
``h2d_copies`` and ``h2d_bytes`` (``engine/index.to_device``),
``d2h_copies`` and ``d2h_bytes`` (``models/scorer._pull``), ``requests``
and ``queries``, and for each rare-postings merge pass (:data:`MERGES`)
``merge_rows.<pass>``, the query rows it merges as launched (pow2-padded),
and ``merge_candidates.<pass>``, those rows times the candidates each
keeps (``engine/split_index.retrieve_topk_split_sparse``). The ``index.split``
span counts the split index's shape (``K``, ``R``, ``R2``, ``entries``,
``entries2``). :func:`counters` returns them with the counters that
live in other modules, read where they are: ``native.calls``,
``native.fallbacks`` and the five ``cuda_*.launches``.
"""

from __future__ import annotations

import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

PREFIX = "bb25: "
CAP = 1_000_000

# The sparse path's merge passes, as their spans are named "merge.<pass>".
MERGES = ("tier-1", "heavy", "tier-2", "tier-2-heavy")

counts = dict.fromkeys(("h2d_copies", "h2d_bytes", "d2h_copies",
                        "d2h_bytes", "requests", "queries")
                       + tuple(f"merge_{c}.{m}" for c in ("rows", "candidates")
                               for m in MERGES), 0)

_on = False
_store: list = []
_dropped = 0
_ids = itertools.count(1)
_local = threading.local()


def _stack() -> list:
    """This thread's open spans; the last one parents new spans."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Null:
    """The span of tracing off: every method does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def add(self, key: str, n: int) -> None:
        pass

    def launched(self, device) -> None:
        pass

    def wait(self) -> None:
        pass

    def close(self) -> None:
        pass


NULL = _Null()


class Span:
    """One span, open from its creation until :meth:`close`. As a
    context manager it parents the spans opened inside the block and
    closes at its end."""

    __slots__ = ("name", "id", "parent", "request", "start", "end",
                 "counts", "_sync", "_range", "_event")

    def __init__(self, name: str, parent, sync: bool = False,
                 profiled: bool = True):
        self.name = name
        self.id = next(_ids)
        self.parent = None if parent is None else parent.id
        self.request = self.id if parent is None else parent.request
        self.counts: dict = {}
        self.end = None
        self._sync = sync
        self._event = None
        self._range = None
        if profiled and _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(PREFIX + name)
            self._range.__enter__()
        self.start = time.perf_counter_ns()

    def __enter__(self):
        _stack().append(self)
        return self

    def __exit__(self, *exc) -> bool:
        _stack().pop()
        self.close()
        return False

    def add(self, key: str, n: int) -> None:
        self.counts[key] = self.counts.get(key, 0) + n

    def launched(self, device) -> None:
        """Mark the end of this request's launches on a CUDA device's
        current stream, for :meth:`wait`."""
        device = torch.device(device)
        if device.type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(device))

    def wait(self) -> None:
        """Wait until the device has run this request's launches."""
        if self._event is not None:
            self._event.synchronize()

    def close(self) -> None:
        """End the span (a second call does nothing) and store it. A
        span made with ``sync=True`` first waits for the device."""
        global _dropped
        if self.end is not None:
            return
        if self._sync and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.end = time.perf_counter_ns()
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        self._event = None
        if len(_store) < CAP:
            _store.append(self)
        else:
            _dropped += 1

    def record(self) -> dict:
        return dict(name=self.name, start=self.start, end=self.end,
                    id=self.id, parent=self.parent, request=self.request,
                    counts=self.counts)


class _Under:
    """Makes an open span the parent of the spans opened in a block,
    without closing it at the block's end."""

    __slots__ = ("span",)

    def __init__(self, sp: Span):
        self.span = sp

    def __enter__(self) -> Span:
        _stack().append(self.span)
        return self.span

    def __exit__(self, *exc) -> bool:
        _stack().pop()
        return False


def span(name: str, sync: bool = False):
    """A span under the innermost open one of this thread (a root where
    none is open); ``sync=True`` ends it with a device synchronize, so
    that it holds its device work. :data:`NULL` while tracing is off."""
    if not _on:
        return NULL
    st = _stack()
    return Span(name, st[-1] if st else None, sync)


def request(n_queries: int):
    """Count a request of ``n_queries`` queries and open its root span
    (:data:`NULL` while tracing is off). The caller closes it once the
    answers are on the host."""
    counts["requests"] += 1
    counts["queries"] += n_queries
    if not _on:
        return NULL
    sp = Span("request", None, profiled=False)
    sp.counts["queries"] = n_queries
    return sp


def under(sp):
    """A block in which ``sp``, open, parents new spans."""
    return NULL if sp is NULL else _Under(sp)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def reset() -> None:
    """Forget the stored spans, ``spans_dropped`` and this module's
    counters (the other modules' counters are reset where they live)."""
    global _store, _dropped
    _store = []
    _dropped = 0
    for key in counts:
        counts[key] = 0


def counters() -> dict:
    """This module's counters, ``spans_dropped``, and the native
    library's calls and fallbacks and the CUDA kernels' launches, by
    flat name."""
    from bayesian_bm25_tpu_torch.engine import (cuda_bm25, cuda_gather,
                                                cuda_matmul, cuda_reduce,
                                                cuda_topk, native)

    out = dict(counts, spans_dropped=_dropped)
    for group, table in (("native.calls", native.calls),
                         ("native.fallbacks", native.fallbacks)):
        out.update({f"{group}.{k}": v for k, v in table.items()})
    for mod in (cuda_reduce, cuda_gather, cuda_topk, cuda_matmul, cuda_bm25):
        out[f"{mod.__name__.rsplit('.', 1)[1]}.launches"] = mod.launches
    return out


def drain() -> dict:
    """The stored spans, as dicts with the keys of :meth:`Span.record`,
    and a snapshot of :func:`counters`; the store is emptied."""
    global _store
    stored, _store = _store, []
    return dict(spans=[sp.record() for sp in stored], counters=counters())
