"""Row and component lookups.

Counterpart of cse168_raytracer_tpu/core/fastgather.py:27,38. There,
`take_rows` used a one-hot matmul and `select_component` a where chain,
both to dodge slow gathers on the TPU. A GPU gathers directly, so both
are plain lookups here; the results are the same values.

`take_rows` is an embedding lookup rather than `table[ids]`: the
backward of advanced indexing accumulates duplicate ids one after
another, and a wavefront of 262,144 rays that all hit one material
made that 45 ms per lookup on an H100, where the embedding's backward
(sort, then a segmented sum) takes a fraction of a millisecond.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def select_component(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr[i, idx[i]] for arr (N, C) and idx (N,) in [0, C)."""
    return arr.gather(1, idx.long()[:, None])[:, 0]


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table[ids] for a 1-D or 2-D table and integer ids of any shape."""
    if not table.is_floating_point():
        return table[ids.long()]
    if table.dim() == 1:
        return F.embedding(ids.long(), table[:, None])[..., 0]
    return F.embedding(ids.long(), table)
