"""Spans of a run's phases, stamped on the profiler's clock.

``with span(name, device):`` marks one phase of :func:`run_mcmc`: the
whole call (``mcmc.run``), the initial draws, a sweep, a stored step, the
Z-marginalized refresh, ... (``mcmc/driver.py``, ``mcmc/state.py``).  A
span records only while a ``torch.profiler`` session records (the
profiler's own flag, ``torch.autograd.profiler._is_profiler_enabled``);
otherwise :func:`span` returns one shared object that does nothing, so an
untraced run pays a flag test and an empty ``with`` a span.

A :class:`Record` holds the span's name, its id, its parent's (the
innermost span open on the thread when it opened), its run's (the id of
the enclosing ``mcmc.run`` span), its host start and end in Unix
nanoseconds (``time.time_ns``, the clock of the profiler's events: a
reader of the device trace can put each idle gap under the span that was
open on the host at that instant) and its device seconds: the time
between two CUDA events on the device's current stream, or the host
duration on the CPU.  The events are read only by :func:`records`, which
waits for them.  A span makes no profiler annotation: the profiler's
trace holds the same operations with spans as without.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

RUN = "mcmc.run"


class Record(NamedTuple):
    """One finished span."""

    name: str
    id: int
    parent: Optional[int]    # the enclosing span's id
    run: Optional[int]       # the enclosing ``mcmc.run`` span's id
    start_ns: int            # host stamps, Unix nanoseconds
    end_ns: int
    device_s: float


class _Off:
    """The span of an untraced run: nothing at all."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_ids = itertools.count(1)
_local = threading.local()
_done: list = []    # closed spans, each made a Record when first read


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "id", "parent", "run", "device", "start_ns",
                 "end_ns", "events")

    def __init__(self, name: str, device):
        self.name = name
        self.id = next(_ids)
        self.device = torch.device(device)
        self.events = None

    def __enter__(self):
        stack = _stack()
        top = stack[-1] if stack else None
        self.parent = None if top is None else top.id
        self.run = (self.id if self.name == RUN
                    else None if top is None else top.run)
        stack.append(self)
        self.start_ns = time.time_ns()
        if self.device.type == "cuda":
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(torch.cuda.current_stream(self.device))
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        self.end_ns = time.time_ns()
        _stack().pop()
        _done.append(self)
        return False

    def record(self) -> Record:
        if self.events is None:
            device_s = (self.end_ns - self.start_ns) * 1e-9
        else:
            self.events[1].synchronize()
            device_s = self.events[0].elapsed_time(self.events[1]) * 1e-3
        return Record(self.name, self.id, self.parent, self.run,
                      self.start_ns, self.end_ns, device_s)


def span(name: str, device):
    """A context manager marking the phase ``name`` of work on ``device``
    (a ``torch.device`` or its name): recorded while a profiler session
    records, nothing otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device)


def records() -> List[Record]:
    """The finished spans in the order they closed, with their device
    seconds (waits for their CUDA events)."""
    for i, s in enumerate(_done):
        if isinstance(s, _Span):
            _done[i] = s.record()
    return list(_done)


def clear() -> None:
    """Forget every finished span."""
    _done.clear()


def totals(recs: List[Record]) -> Dict[str, Dict[str, float]]:
    """Per span name: the count, the total device seconds and the total
    self seconds (each span's device seconds less its children's)."""
    children: Dict[int, float] = {}
    for r in recs:
        if r.parent is not None:
            children[r.parent] = children.get(r.parent, 0.0) + r.device_s
    out: Dict[str, Dict[str, float]] = {}
    for r in recs:
        row = out.setdefault(r.name, {"count": 0, "device_s": 0.0,
                                      "self_s": 0.0})
        row["count"] += 1
        row["device_s"] += r.device_s
        row["self_s"] += r.device_s - children.get(r.id, 0.0)
    return out
