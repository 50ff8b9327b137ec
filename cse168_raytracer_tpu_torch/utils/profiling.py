"""Phase timing and device traces.

Counterpart of cse168_raytracer_tpu/utils/profiling.py (the reference's
getTime() spans around preCalc, BVH, photon and render phases,
Utility.cpp:32-48, Scene.cpp:54-82,108,175,206): `phase` times a named
span on the host clock and, given a result, waits for the CUDA devices
its tensors live on, so device work is inside the span; `spans` and
`reset` read and clear the running totals; `device_trace` records a
torch.profiler trace (the card's kernels too, where there is one) and
writes it to a directory as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch

from cse168_raytracer_tpu_torch.utils import console

_SPANS: dict[str, float] = {}


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
    """Time a named phase. `result` (a tensor, a structure of tensors,
    or a callable returning one, called at exit) is waited for: every
    CUDA device holding one of its tensors is synchronised."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if result is not None:
            for dev in _cuda_devices(result() if callable(result)
                                     else result):
                torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        _SPANS[name] = _SPANS.get(name, 0.0) + dt
        if log:
            console.debug("[%s] %.3fs", name, dt)


def spans() -> dict[str, float]:
    return dict(_SPANS)


def reset() -> None:
    _SPANS.clear()


@contextlib.contextmanager
def device_trace(logdir: Optional[str]):
    """Record a torch.profiler trace of the block (CPU activity, and the
    card's where CUDA is available) and write it to
    logdir/trace.json (chrome://tracing, Perfetto). A no-op when logdir
    is None."""
    if not logdir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
