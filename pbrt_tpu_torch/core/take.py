"""Row gathers of small scene tables by per-ray indices.

`take(table, idx)` is `table[idx]`. When autograd will differentiate the
table, it gathers through `embedding` instead, whose backward sums the
rows of duplicate indices by sorting them (a segmented reduction).
Indexing's backward (`index_put_` with accumulate) adds the duplicates of
an index one after another: on an H100, 12 ms per gather of a 5-row
material table by the 131,072 rays of a bench pass, 93% of the device
time of a forward+backward pass (scripts/profile_torch_fwdbwd.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] along the first axis, with a fast backward."""
    if not (table.requires_grad and torch.is_grad_enabled()):
        return table[idx]
    rows = F.embedding(idx, table.reshape(table.shape[0], -1))
    return rows.reshape(*idx.shape, *table.shape[1:])
