"""One module a kind of timed iteration, found by the name a traffic
file gives under "iteration" (traffic/<traffic>.json holds the
parameters; iterations/<kind>.py the code that runs them).

A module defines
  setup(cell, ctx, seed, device, sync) -> loop
      the program's state for the cell (harness.port_scene builds the
      configuration's scene with the traffic's accelerator), made from
      the seed; spans it times go to ctx.spans;
  reference(cell, seed, device, dtype) -> ref
      the plain reference of the cell in `dtype`.
A loop is callable: loop(i) runs iteration i (i < 0: a warm-up, on
inputs that no window reaches) and returns its outputs and the inputs
the reference needs to redo it, a dict with "i"; it has
samples_per_iter, and finish() -> dict, which hands the check what it
needs of the program's state and frees the rest. A reference has
outputs(kept) -> its own answers to a kept iteration's inputs, and
view(kept, state) -> the program's outputs in the same layout (`state`
is what finish() gave). The numbers compared are compare/<number>.py,
named by limits/<cell>.json.
"""
