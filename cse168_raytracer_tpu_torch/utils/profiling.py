"""The port's tracer: set-up phases, per-iteration spans and counters.

Counterpart of cse168_raytracer_tpu/utils/profiling.py (the reference's
getTime() spans around preCalc, BVH, photon and render phases,
Utility.cpp:32-48, Scene.cpp:54-82,108,175,206). Three kinds of record,
placed at the port's layer boundaries:

- `phase(name)` times a set-up step on the host clock (scene.build,
  accel.build and its accel.sah / accel.wide / accel.upload,
  kernels.load, photons.build) and keeps a total by name, always
  (`spans()`); a phase inside a phase of the same name on the same
  thread adds nothing, so only the outermost call counts. Given a
  result, it waits for the CUDA devices holding it.
- `span(name)` marks a step of the per-iteration path: render.frame,
  render.band, integrate.level and its stages, bvh.launch,
  segment_sum.launch, sync.<site>, the backward roots. It records only
  into an open Sink: the name, its parent and root on the same thread,
  perf_counter_ns start and end, and the thread. With no sink open and
  no profiler recording it returns one shared null context: it
  allocates nothing, launches nothing and never synchronizes.
- counters are host integers in one registry, COUNTS, always on:
  launch.<kernel>.<mode> (the kernel wrappers' launches), bvh.lanes
  (lanes handed to the traversal kernels), pool.scanned.<kind> /
  pool.skipped.<kind> (the ray casts' passes over the sphere and plane
  pools, run or skipped as empty, on every device) and sync.<site>
  (`sync`: each blocking host-device call of the hot path on a CUDA
  tensor).

While a torch profiler records (torch.autograd._profiler_enabled()),
span and phase also open a record_function range of their name: the
spans become events of the profiler's own trace, on the clock of its
device operations, so a gap on the device can be put down to the span
the host was in.

A Sink is opened and closed by its caller (`recording()`, or by
setting SINK). While it is open and not paused it gathers the spans,
the counters' increments, and what the path hands to `record`: each
segment_sum call's (terms, columns, rows) and each integrate's
RenderStats ray counters (primary, secondary, shadow) as the 0-d device
tensors they are, read only after the sink closes. `device_record`
hands it a dict that the block fills, and on the card times the block
on the device by a pair of CUDA events, resolved after the sink closes
(`device_ms`); the photon gather's "photon_gather" record is one.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from typing import Callable, NamedTuple, Optional

import torch
from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function

from cse168_raytracer_tpu_torch.utils import console

COUNTS: dict[str, int] = {}
SINK: Optional["Sink"] = None
_PHASES: dict[str, float] = {}
_NULL = contextlib.nullcontext()
# the backward's thread counts too: an increment is a read and a write
_COUNT_LOCK = threading.Lock()


class _Local(threading.local):
    def __init__(self):
        self.stack = []       # (id, root id) of the open spans
        self.phases = set()   # names of the open phases


_local = _Local()
_next_id = itertools.count(1).__next__


class SpanRecord(NamedTuple):
    name: str
    id: int
    parent: Optional[int]   # the enclosing span's id on the same thread
    root: int               # the outermost enclosing span's id (own id)
    start_ns: int           # time.perf_counter_ns()
    end_ns: int
    thread: int             # threading.get_ident()


class Sink:
    """What the tracer gathers while it is open: `spans`
    [SpanRecord], `counts` {counter: increment} and `records` {kind:
    [value]}. `paused()` true drops what arrives."""

    def __init__(self, paused: Optional[Callable[[], bool]] = None):
        self.spans: list[SpanRecord] = []
        self.counts: dict[str, int] = {}
        self.records: dict[str, list] = {}
        self.paused = paused or (lambda: False)

    def count(self, name: str, n: int) -> None:
        if not self.paused():
            self.counts[name] = self.counts.get(name, 0) + n

    def record(self, kind: str, value) -> None:
        if not self.paused():
            self.records.setdefault(kind, []).append(value)


class _Span:
    __slots__ = ("name", "sink", "range", "id", "parent", "root", "t0")

    def __init__(self, name: str, sink: Optional[Sink], profiled: bool):
        self.name, self.sink = name, sink
        self.range = record_function(name) if profiled else None

    def __enter__(self):
        if self.range is not None:
            self.range.__enter__()
        if self.sink is not None:
            stack = _local.stack
            self.id = _next_id()
            self.parent, self.root = stack[-1] if stack else (None, self.id)
            stack.append((self.id, self.root))
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.sink is not None:
            t1 = time.perf_counter_ns()
            _local.stack.pop()
            if not self.sink.paused():
                self.sink.spans.append(SpanRecord(
                    self.name, self.id, self.parent, self.root, self.t0, t1,
                    threading.get_ident()))
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str):
    """A context manager marking `name` on the per-iteration path."""
    sink = SINK
    if sink is None and not _profiler_enabled():
        return _NULL
    return _Span(name, sink, _profiler_enabled())


def traced(name: str):
    """Decorator: every call of the function inside span(name). (A
    set-up function takes @phase(name), which is a decorator too.)"""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` (and to an open sink's increments)."""
    with _COUNT_LOCK:
        COUNTS[name] = COUNTS.get(name, 0) + n
        if SINK is not None:
            SINK.count(name, n)


def sync(site: str, on, n: int = 1):
    """Mark n blocking host-device calls at `site`: where `on` (a tensor
    or a device) is a CUDA one, add n to the counter sync.<site> and
    return span("sync.<site>") to wrap them; else a null context."""
    cuda = on.is_cuda if isinstance(on, torch.Tensor) else on.type == "cuda"
    if not cuda or n == 0:
        return _NULL
    count("sync." + site, n)
    return span("sync." + site)


def record(kind: str, value) -> None:
    """Hand `value` to the open sink, if any, under `kind`."""
    if SINK is not None:
        SINK.record(kind, value)


class _DeviceRecord:
    __slots__ = ("kind", "sink", "rec", "cuda")

    def __init__(self, kind: str, sink: Sink, cuda: bool):
        self.kind, self.sink, self.cuda = kind, sink, cuda
        self.rec = {}

    def __enter__(self):
        if self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self.rec["events"] = (start,)
        return self.rec

    def __exit__(self, *exc):
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.rec["events"] += (end,)
        self.sink.record(self.kind, self.rec)
        return False


def device_record(kind: str, on):
    """A context manager that yields a dict for the block to fill and
    hands it to the open sink under `kind` at its end; where `on` (a
    tensor or a device) is a CUDA one, the dict's "events" are a start
    and an end torch.cuda.Event recorded on the current stream around
    the block, so `device_ms(rec)` reads the block's device time once
    the work has finished (after the sink closes: reading it inside
    would wait for the card). With no sink open, or a paused one, it
    yields None and creates nothing: no event, no dict."""
    sink = SINK
    if sink is None or sink.paused():
        return _NULL
    cuda = on.is_cuda if isinstance(on, torch.Tensor) else on.type == "cuda"
    return _DeviceRecord(kind, sink, cuda)


def device_ms(rec: dict) -> Optional[float]:
    """Milliseconds between a device_record's two events (None without
    them, as off the card); waits for the end event."""
    events = rec.get("events")
    if events is None or len(events) != 2:
        return None
    events[1].synchronize()
    return events[0].elapsed_time(events[1])


def declare(prefix: str, names) -> None:
    """Counters prefix.<name> that read 0 until counted."""
    for n in names:
        COUNTS.setdefault(f"{prefix}.{n}", 0)


def counts(prefix: str = "") -> dict[str, int]:
    """The counters under `prefix` ("launch.wide"), named without it."""
    p = prefix + "." if prefix else ""
    return {k[len(p):]: v for k, v in COUNTS.items() if k.startswith(p)}


def set_counts(prefix: str, values: dict) -> None:
    """Set the counters prefix.<name> to values[name]."""
    for n, v in values.items():
        COUNTS[f"{prefix}.{n}"] = v


@contextlib.contextmanager
def recording(paused: Optional[Callable[[], bool]] = None):
    """Open a Sink for the block and yield it; it closes at the end."""
    global SINK
    if SINK is not None:
        raise RuntimeError("a sink is already open")
    SINK = sink = Sink(paused)
    try:
        yield sink
    finally:
        SINK = None


def _cuda_devices(obj) -> set:
    """The CUDA devices of the tensors in obj (nested tuples, lists,
    dicts and dataclass-like objects)."""
    if isinstance(obj, torch.Tensor):
        return {obj.device} if obj.is_cuda else set()
    if isinstance(obj, dict):
        obj = list(obj.values())
    elif hasattr(obj, "__dict__") and not isinstance(obj, type):
        obj = list(vars(obj).values())
    if isinstance(obj, (tuple, list)):
        return set().union(*(_cuda_devices(x) for x in obj))
    return set()


@contextlib.contextmanager
def phase(name: str, result=None, log: bool = True):
    """Time a set-up phase into its total by name. `result` (a tensor, a
    structure of tensors, or a callable returning one, called at exit)
    is waited for: every CUDA device holding one of its tensors is
    synchronised. Inside a phase of the same name on this thread it
    times nothing."""
    if name in _local.phases:
        yield
        return
    _local.phases.add(name)
    rng = record_function(name) if _profiler_enabled() else None
    if rng is not None:
        rng.__enter__()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if result is not None:
            for dev in _cuda_devices(result() if callable(result)
                                     else result):
                torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        _local.phases.discard(name)
        _PHASES[name] = _PHASES.get(name, 0.0) + dt
        if rng is not None:
            rng.__exit__(None, None, None)
        if log:
            console.debug("[%s] %.3fs", name, dt)


def spans() -> dict[str, float]:
    """Seconds of each phase so far, by name (a copy)."""
    return dict(_PHASES)


def reset() -> None:
    """Forget the phases' totals."""
    _PHASES.clear()
