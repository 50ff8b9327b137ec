"""Row and component lookups.

Counterpart of cse168_raytracer_tpu/core/fastgather.py:27,38. There,
`take_rows` used a one-hot matmul and `select_component` a where chain,
both to dodge slow gathers on the TPU. A GPU gathers directly, so both
are plain lookups here; the results are the same values.

`take_rows` of a float table that needs a gradient is `_TakeRows`: its
forward is an embedding lookup, its backward ops/segment_sum.py, which
sums each row's cotangents in one fixed order (a parallel tree over the
row's lanes), so the card's table gradient is the CPU's bit for bit.
Neither of the obvious backwards does that: the embedding's own
(embedding_dense_backward) sums partial segments on the card and adds in
lane order on the CPU, and the backward of `table[ids]` accumulates
duplicate ids one after another, which took 45 ms per lookup on an H100
when a wavefront of 262,144 rays all hit one material. So does a pass
per term of the longest run (render/integrator.add_in_lane_order's
pattern): such a run has 262,144 terms.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cse168_raytracer_tpu_torch.ops.segment_sum import segment_sum
from cse168_raytracer_tpu_torch.utils import profiling


def select_component(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr[i, idx[i]] for arr (N, C) and idx (N,) in [0, C)."""
    return arr.gather(1, idx.long()[:, None])[:, 0]


class _TakeRows(torch.autograd.Function):
    """table[ids] for a 2-D float table; the gradient is the segmented
    sum of the cotangent rows by id."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.n_rows = table.shape[0]
        return F.embedding(ids, table)

    @staticmethod
    @profiling.traced("backward.take_rows")
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        cols = g.shape[-1]
        return segment_sum(g.reshape(-1, cols), ids.reshape(-1),
                           ctx.n_rows), None


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table[ids] for a 1-D or 2-D table and integer ids of any shape."""
    if not table.is_floating_point():
        return table[ids.long()]
    tab = table[:, None] if table.dim() == 1 else table
    if tab.requires_grad and torch.is_grad_enabled():
        out = _TakeRows.apply(tab, ids.long())
    else:
        out = F.embedding(ids.long(), tab)
    return out[..., 0] if table.dim() == 1 else out
