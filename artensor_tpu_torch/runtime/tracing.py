"""The port's one recorder of spans and counters.

A span is a phase of the program: its name, its start and end
(``time.perf_counter_ns``), its parent (the innermost span kept open
around it on the same thread) and its attributes.  Spans come in two
levels:

- set-up spans (``span``): plan load and scheme compile, fold and stage,
  graph capture, a contraction.  A handful a process; always kept.
- per-batch and per-step spans (``hot``): the runner's call and its
  parts, one span a step of an eager run.  Kept only while tracing is
  enabled (``enable``).  Disabled, ``hot`` costs one test of the module
  flag ``ENABLED`` and hands back ``NULL``, which does nothing; ``timed``
  (the runner's call) still measures its block, for the runner's
  ``stats``, but keeps nothing.

While tracing is enabled every kept span also enters
``torch.profiler.record_function(name)``, so an active profiler's
timeline names the program's phases on the profiler's own clock.
Disabled, nothing enters it: a profiled run sees only its own events.

Spans are kept in memory in two bounded rings, one a level; counters
(``count``) in a dict.  There is no exporter: ``contraction(profile_dir=
...)`` writes the profiler's trace, which carries the spans' names.

    from artensor_tpu_torch.runtime import tracing

    with tracing.span("scheme.fuse") as sp:
        ...
        sp.attrs["compiles"] = n
    tracing.spans("scheme.fuse")[-1].seconds
"""

import itertools
import threading
import time
from collections import deque

import torch

ENABLED = False
SETUP_RING = 4096       # set-up spans kept, the newest
HOT_RING = 1 << 16      # per-batch and per-step spans kept, the newest

_setup = deque(maxlen=SETUP_RING)
_hot = deque(maxlen=HOT_RING)
_counters = {}
_ids = itertools.count(1)
_local = threading.local()


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    """One span; a context manager.  ``seconds``: its duration, once
    closed.  ``attrs`` may be filled in while it is open."""

    __slots__ = ("name", "id", "parent", "start", "end", "attrs", "_ring",
                 "_rf")

    def __init__(self, name, attrs, ring):
        self.name, self.attrs, self._ring = name, attrs, ring
        self.id = self.parent = self._rf = None
        self.start = self.end = 0

    @property
    def seconds(self):
        return 1e-9 * (self.end - self.start)

    def __enter__(self):
        if self._ring is not None:
            if ENABLED:
                rf = torch.profiler.record_function(self.name)
                rf.__enter__()
                self._rf = rf
            stack = _stack()
            self.id = next(_ids)
            self.parent = stack[-1].id if stack else None
            stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        if self._ring is not None:
            if self._rf is not None:
                self._rf.__exit__(*exc)
                self._rf = None
            _stack().pop()
            self._ring.append(self)
        return False

    def __repr__(self):
        return (f"Span({self.name!r}, {self.seconds:.6f} s, id {self.id}, "
                f"parent {self.parent}, {self.attrs})")


class _Null:
    """A disabled span: enters nothing, keeps nothing."""

    __slots__ = ()
    attrs = {}
    seconds = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL = _Null()


def span(name, **attrs):
    """A set-up span: always timed and kept."""
    return Span(name, attrs, _setup)


def hot(name, **attrs):
    """A per-batch or per-step span: kept while tracing is enabled, else
    ``NULL``."""
    if not ENABLED:
        return NULL
    return Span(name, attrs, _hot)


def timed(name, **attrs):
    """A per-batch span that is always timed (its ``seconds``) and kept
    only while tracing is enabled."""
    return Span(name, attrs, _hot if ENABLED else None)


def note(**attrs):
    """Add ``attrs`` to the innermost open span, while tracing is enabled
    (a step's kernel form, known only where its kernel is launched)."""
    if ENABLED:
        stack = _stack()
        if stack:
            stack[-1].attrs.update(attrs)


def count(name, n=1):
    """Add ``n`` to the counter ``name``."""
    _counters[name] = _counters.get(name, 0) + n


def enable(on=True):
    """Keep per-batch and per-step spans (``on``) or not; returns the
    previous setting."""
    global ENABLED
    prev, ENABLED = ENABLED, bool(on)
    return prev


def disable():
    return enable(False)


def enabled():
    return ENABLED


def spans(name=None):
    """The kept spans of both levels (of ``name``), in start order."""
    out = [s for s in itertools.chain(_setup, _hot)
           if name is None or s.name == name]
    out.sort(key=lambda s: s.start)
    return out


def last(name):
    """The kept span ``name`` that started last, or None."""
    found = [s for s in itertools.chain(_setup, _hot) if s.name == name]
    return max(found, key=lambda s: s.start) if found else None


def children(parent, name=None):
    """The kept spans directly under ``parent`` (of ``name``), in start
    order."""
    return [s for s in spans(name) if s.parent == parent.id]


def self_seconds(parent):
    """``parent``'s seconds less its kept children's."""
    return parent.seconds - sum(c.seconds for c in children(parent))


def counters():
    return dict(_counters)


def reset():
    """Forget every kept span and counter."""
    _setup.clear()
    _hot.clear()
    _counters.clear()
