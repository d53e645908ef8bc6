"""Tracing, the program's spans and structured metrics (port of
``diffusionremotesensing_tpu/profiling.py``).

* :func:`trace`: ``torch.profiler`` over a block, its timeline written as a
  Chrome/Perfetto trace into a directory; the spans below show in it above
  the kernels they issued;
* :func:`annotate`: the program's span, a ``with`` block at a layer
  boundary; :func:`begin` a span that another thread may end (a request's
  wait in a queue);
* :func:`recording`, :func:`spans`, :func:`clear`: what reads the spans;
* :class:`MetricsLogger`: an append-only JSONL file of per-epoch scalars.

A span records its name, start and end (``time.time_ns()``, the clock on
which ``torch.profiler``'s events are stamped, so a span lies against the
device trace's kernels and idle gaps), its own id, its parent's id (the
innermost span open on the same thread) and a few attributes: the counts of
the work done inside it (rows, a chunk or step index, a request id).

Spans are recorded only while something reads them: while a
``torch.profiler`` session is active in the process (``trace``, a
benchmark's traced run), or inside :func:`recording`. Otherwise a span site
reads two flags and returns a shared null context: no clock read, no span
made, nothing kept. While a profiler session is active a :func:`annotate`
span also opens a ``record_function`` range of its name in the profiler's
timeline; a :func:`begin` span, whose end may fall on another thread, stays
in memory only. The spans are kept in one list per process, up to
``MAX_SPANS``; later ones are counted as dropped (:func:`dropped`).

Spans by layer (parent > child), and their attributes:

* serving: ``serve.queue`` a request, from ``MicroBatcher.submit`` to the
  worker taking it into a batch (``request``; its parent the batch's
  span); ``serve.batch`` (``rows``, ``max_batch``) from the worker taking
  the batch's first request to the answers on the host >
  ``serve.prepare``, ``sampler.call``, ``serve.copy_out``;
* aggregation: ``aggregation.call`` (``tiles``) > ``aggregation.prepare``,
  ``aggregation.issue`` (``chunk``, ``rows``) > ``sampler.call``,
  ``aggregation.wait``, ``aggregation.copy_out``, ``aggregation.blend``
  (``chunk``, ``rows``), ``aggregation.finish``;
* samplers: ``sampler.call`` (``rows``) > ``sampler.step`` (``step``,
  ``t``, ``rows``), the host's issue of one step;
* training: ``train.step`` (``step``) > ``train.forward``,
  ``train.backward``, ``train.optimizer``, ``train.ema``.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["trace", "annotate", "begin", "recording", "spans", "dropped", "clear",
           "MetricsLogger"]

MAX_SPANS = 1 << 18

_recording = 0  # open recording() blocks
_spans: List["Span"] = []
_dropped = 0
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()  # .stack: the spans open on this thread, innermost last


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Profile the block's CPU and CUDA activity into
    ``log_dir/trace.json`` (nothing when ``log_dir`` is empty); the
    program's spans inside the block are ranges of its timeline."""
    if not log_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Span:
    """One recorded span: ``name``, ``start`` and ``end`` (ns,
    ``time.time_ns``; ``end`` None while open), ``id``, ``parent`` (an id or
    None) and ``attrs``. ``span[key] = value`` sets an attribute."""

    __slots__ = ("name", "start", "end", "id", "parent", "attrs", "_region")

    def __init__(self, name: str, attrs: Dict[str, Any], parent: Optional[int]):
        self.name, self.attrs, self.parent = name, attrs, parent
        self.id = next(_ids)
        self.end = None
        self._region = None
        self.start = time.time_ns()

    def __setitem__(self, key: str, value) -> None:
        self.attrs[key] = value

    def finish(self, parent=None) -> None:
        """End the span and keep it; ``parent`` (a span) is named its parent
        where it has none (a span begun on another thread)."""
        self.end = time.time_ns()
        if self.parent is None and parent is not None:
            self.parent = parent.id
        _keep(self)

    def __enter__(self) -> "Span":
        _stack().append(self)
        if _autograd_profiler._is_profiler_enabled:
            self._region = torch.profiler.record_function(self.name)
            self._region.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self._region is not None:
            self._region.__exit__(*exc)
            self._region = None
        _stack().pop()
        self.finish()
        return False


class _Null:
    """The span of every site while nothing records: does nothing."""

    __slots__ = ()
    id = None

    def __bool__(self) -> bool:
        return False

    def __enter__(self) -> "_Null":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def __setitem__(self, key: str, value) -> None:
        pass

    def finish(self, parent=None) -> None:
        pass


NULL = _Null()


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def _keep(span: Span) -> None:
    global _dropped
    with _lock:
        if len(_spans) < MAX_SPANS:
            _spans.append(span)
        else:
            _dropped += 1


def annotate(name: str, **attrs):
    """The program's span over a ``with`` block, its parent the innermost
    span open on this thread; while a profiler session is active also a
    ``record_function`` range of ``name`` in its timeline. While nothing
    records, the shared null span (falsy)."""
    if not (_recording or _autograd_profiler._is_profiler_enabled):
        return NULL
    stack = _stack()
    return Span(name, attrs, stack[-1].id if stack else None)


def begin(name: str, **attrs):
    """A span begun now and ended by its ``finish(parent)``, on any thread
    (kept in memory only, never in the profiler's timeline). While nothing
    records, the shared null span."""
    if not (_recording or _autograd_profiler._is_profiler_enabled):
        return NULL
    return Span(name, attrs, None)


@contextlib.contextmanager
def recording():
    """Record the program's spans inside the block, with or without a
    profiler session (an operator's script: ``with recording(): ...``,
    then :func:`spans`)."""
    global _recording
    with _lock:
        _recording += 1
    try:
        yield
    finally:
        with _lock:
            _recording -= 1


def spans() -> List[Span]:
    """The spans ended so far, in the order they ended."""
    with _lock:
        return list(_spans)


def dropped() -> int:
    """The spans ended beyond ``MAX_SPANS``, not kept."""
    return _dropped


def clear() -> None:
    """Forget the spans kept and the count dropped."""
    global _dropped
    with _lock:
        _spans.clear()
        _dropped = 0


class MetricsLogger:
    """Append-only JSONL metrics file (a no-op without a path)."""

    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        else:
            self._fh = None

    def log(self, **metrics: Any) -> None:
        if self._fh is None:
            return
        metrics.setdefault("ts", time.time())
        self._fh.write(json.dumps(_to_plain(metrics)) + "\n")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def _to_plain(tree: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        try:
            out[k] = float(v) if hasattr(v, "__float__") and not isinstance(v, (int, bool)) else v
        except (TypeError, ValueError):
            out[k] = str(v)
    return out
