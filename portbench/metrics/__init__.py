"""One module a metric, found by the metric's name in BENCHMARK.json.

A module defines read(ctx), which returns the metric's value or None
where the run holds nothing to read (the harness then leaves the metric
out of the result line), and may define install(ctx), called before a
traced window to wrap what the metric reads (ctx.patch undoes each
wrapper after the window). `ctx` is portbench.harness.Context.
"""
