#!/usr/bin/env python3
"""The readings that a cell's limits (portbench/limits/<cell>.json) are
set from, on the card at the cell's own size, in one process.

    python3 portbench/calibrate.py --workload <cell> --seeds 11 12 ... \
        [--control-seeds 11 12 13]

For each seed: the cell set up from that seed (iterations/<kind>.py),
a window long enough to keep what a run keeps (the first iteration, the
one drawn from the seed, the last), and the numbers compared against the
reference (the lower readings). For each control seed: the reference
computed in bfloat16, the precision below the configurations' float32,
in the program's place (the upper readings). One JSON line a reading;
the benchmark's runs never run this.
"""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
sys.path.insert(0, ROOT)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    from portbench import harness
    if not torch.cuda.is_available():
        raise SystemExit("calibrate: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    sync = torch.cuda.synchronize
    cell = harness.Cell(args.workload)
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        ctx, loop = harness.setup(cell, seed, dev, sync)
        pick = 1 + int(np.random.default_rng(seed).integers(0, 31))
        kept = harness.window(ctx, loop, 0.0, seed, sync,
                              min_iters=pick + 2)
        run = harness.finish(cell, ctx, loop, kept, len(ctx.iter_s), dev)
        ref = cell.iteration.reference(cell, seed, dev)
        rows = []
        if seed in args.seeds:
            rows.append(("program", None))
        if seed in args.control_seeds:
            rows.append(("control_bf16", cell.iteration.reference(
                cell, seed, dev, torch.bfloat16)))
        for kind, stand_in in rows:
            t0 = time.perf_counter()
            nums = harness.judge(cell, seed, run, dev, reference=ref,
                                 low=stand_in)
            print(json.dumps({"cell": cell.name, "kind": kind, "seed": seed,
                              "iters": sorted(kept),
                              "seconds": time.perf_counter() - t0,
                              "numbers": nums}), flush=True)
        del run, ref, rows, loop
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
