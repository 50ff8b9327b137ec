"""The segment-sum kernels' share of their roofline: the least time of
every segment_sum call of the traced window (portbench/roofline.py,
segment_sum_call: terms and ids read once, output rows written once;
shapes recorded by wrapping the function from outside) over the union
of the device time of the kernels whose names hold "segsum"."""

import sys

from portbench import roofline
from portbench.trace import union_us


def install(ctx):
    from cse168_raytracer_tpu_torch.ops import segment_sum as ss
    real = ss.segment_sum
    calls = ctx.calls.setdefault("segment_sum", [])

    def wrapped(values, ids, n_rows, *a, **k):
        if not ctx.probing:
            calls.append((values.shape[0], values.shape[1], int(n_rows)))
        return real(values, ids, n_rows, *a, **k)
    # every module of the port that imported the function by name
    for mod in list(sys.modules.values()):
        if (getattr(mod, "__name__", "").split(".")[0]
                == "cse168_raytracer_tpu_torch"
                and getattr(mod, "segment_sum", None) is real):
            ctx.patch(mod, "segment_sum", wrapped)


def read(ctx):
    calls = ctx.calls.get("segment_sum")
    if ctx.trace is None or not calls:
        return None
    spans = [(s, e) for n, s, e in ctx.trace.kernels()
             if "segsum" in n.lower()]
    if not spans:
        return None
    least = sum(roofline.least_seconds(*roofline.segment_sum_call(*c))[0]
                for c in calls)
    return 100.0 * least / (union_us(spans) / 1e6)
