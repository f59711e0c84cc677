"""Spans and counters of the port: where its host time goes, and how often
it launches a kernel or waits for a device.

Counters count always (an integer add):

* :data:`LAUNCHES` -- kernel launches by kernel name; a fused wrapper adds
  one where it launches its kernel and nowhere else
  (:func:`~..ops._launch.launch`), so a run shows which kernels it went
  through;
* :data:`SYNCS` -- the host's waits for a device, by site: every read of a
  device value back to the host and every copy of host data to a card on
  the main paths goes through :func:`sync` (or :func:`to_device`), which
  counts it.

Spans are recorded only while a ``torch.profiler`` session is active (the
benchmark's traced window; :func:`~.profiling.trace`).  Otherwise
:func:`span` returns one shared no-op context after a single flag test.  A
span holds its name, ``start_ns`` and ``end_ns`` on ``time.time_ns`` (the
clock of the profiler's device events, so an idle gap on a card can be set
against the span the host was in), its own id, its parent's (the span open
around it, None for a root) and its root's (the entry call it belongs to,
shared by every span of that call), and a few attributes (``device``,
``shard``, ``kernel``, ``site``).  Spans are kept in memory, at most
:data:`CAP` of them; later ones are dropped and counted.  One host thread
records: the open spans form one stack.

The spans of the main paths (a fit's DE, the regional objectives, the
mesh, the ``ops`` wrappers) and what reads them are listed in ``PERF.md``
(its layers).
"""

import contextlib
import functools
import itertools
import time

import torch
import torch.autograd.profiler as _profiler

# Spans kept in memory; spans past it are dropped and counted.
CAP = 1 << 18

# Kernel launches since the last reset, by kernel name.
LAUNCHES = {}
# The host's waits for a device since the last reset, by site.
SYNCS = {}

_spans = []                  # finished spans, in the order they ended
_open = []                   # spans entered and not yet left, outermost first
_ids = itertools.count(1)
_dropped = 0
_NO_SPAN = contextlib.nullcontext()


def register_kernels(*names):
    """Give each named kernel a launch count, starting at 0."""
    for name in names:
        LAUNCHES.setdefault(name, 0)


def reset_launches():
    for name in LAUNCHES:
        LAUNCHES[name] = 0


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "root", "start_ns",
                 "end_ns")

    def __init__(self, name, attrs):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        outer = _open[-1] if _open else None
        self.id = next(_ids)
        self.parent = None if outer is None else outer.id
        self.root = self.id if outer is None else outer.root
        _open.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        global _dropped
        self.end_ns = time.time_ns()
        _open.pop()
        if len(_spans) < CAP:
            _spans.append(self)
        else:
            _dropped += 1
        return False


def span(name, **attrs):
    """A context manager that records a span ``name`` with ``attrs`` while
    a profiler session is active, else the shared no-op."""
    if not _profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name, attrs)


def traced(name):
    """Decorator: each call of the function runs inside a span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Span(name, {}):
                return fn(*args, **kwargs)
        return inner
    return wrap


def annotate(**attrs):
    """Add ``attrs`` to the innermost open span (nothing where none is
    open)."""
    if _open:
        _open[-1].attrs.update(attrs)


def sync(site, read, *args, **kwargs):
    """``read(*args, **kwargs)``, a read or copy that makes the host wait
    for a device: one count under ``SYNCS[site]`` and, where spans are
    recorded, a ``sync`` span with its ``site`` around the wait alone."""
    SYNCS[site] = SYNCS.get(site, 0) + 1
    if not _profiler._is_profiler_enabled:
        return read(*args, **kwargs)
    with _Span("sync", {"site": site}):
        return read(*args, **kwargs)


def to_device(site, data, dtype, device):
    """``torch.as_tensor(data, dtype=dtype, device=device)``; where host
    data goes to a card (a pageable copy, which waits for the card's
    stream) it is a :func:`sync` at ``site``."""
    device = torch.device(device)
    on_host = (not isinstance(data, torch.Tensor)
               or data.device.type == "cpu")
    if device.type == "cpu" or not on_host:
        return torch.as_tensor(data, dtype=dtype, device=device)
    return sync(site, torch.as_tensor, data, dtype=dtype, device=device)


def spans():
    """The recorded spans, oldest start first: dicts of ``name``,
    ``start_ns``, ``end_ns``, ``id``, ``parent``, ``root`` and
    ``attrs``."""
    return [{"name": s.name, "start_ns": s.start_ns, "end_ns": s.end_ns,
             "id": s.id, "parent": s.parent, "root": s.root,
             "attrs": dict(s.attrs)}
            for s in sorted(_spans, key=lambda s: (s.start_ns, s.id))]


def counters():
    """``{'launches': {kernel: n}, 'syncs': {site: n}, 'spans_dropped':
    n}``, as they stand."""
    return {"launches": dict(LAUNCHES), "syncs": dict(SYNCS),
            "spans_dropped": _dropped}


def reset():
    """Forget the recorded spans and zero every counter."""
    global _dropped
    _spans.clear()
    _dropped = 0
    SYNCS.clear()
    reset_launches()
