"""SelectedRows: a sparse set of a table's rows, the gradient of a
sparse embedding (counterpart of paddle_tpu/selected_rows.py).

values [N, ...] and rows [N] (int32, repeats allowed) with a static
height: N is the step's number of lookups, fixed by its feed's shape,
so a segment that carries one keeps its shapes and still captures. The
Executor moves a SelectedRows between segments, into and out of a
captured graph and through its fetches as the (values, rows) pair.
Optimizer emitters apply it as a scatter update; the other ops take
its dense form (to_dense) where they need the merged rows.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ['SelectedRows']


class SelectedRows(object):
    __slots__ = ('values', 'rows', 'height')

    def __init__(self, values, rows, height):
        self.values = values        # [N, ...] gradient rows
        self.rows = rows            # [N] int32 row ids (repeats allowed)
        self.height = int(height)   # dense dim 0

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def dense_shape(self):
        return (self.height,) + tuple(self.values.shape[1:])

    def to_dense(self):
        """Dense [height, ...] with repeated rows summed. index_put_ with
        accumulate sorts the rows and sums each row's parts in one order,
        so two runs give the same bits on the card (index_add_ sums with
        atomics)."""
        values = torch.as_tensor(self.values)
        rows = torch.as_tensor(self.rows, device=values.device).long()
        z = torch.zeros(self.dense_shape, dtype=values.dtype,
                        device=values.device)
        return z.index_put_((rows,), values, accumulate=True)

    def numpy(self):
        return _host(self.to_dense())

    def merged(self):
        """Host-side dedup: the values of repeated rows summed, rows
        ascending. Returns a numpy-backed SelectedRows."""
        rows = _host(self.rows)
        vals = _host(self.values)
        uniq, inv = np.unique(rows, return_inverse=True)
        out = np.zeros((len(uniq),) + vals.shape[1:], vals.dtype)
        np.add.at(out, inv, vals)
        return SelectedRows(out, uniq.astype('int32'), self.height)

    def map(self, fn):
        """fn applied to values and to rows: the same kind of value
        (a clone, a copy to the host, ...)."""
        return SelectedRows(fn(self.values), fn(self.rows), self.height)

    def __repr__(self):
        return 'SelectedRows(height=%d, nrows=%s, value_shape=%s)' % (
            self.height, tuple(self.rows.shape), tuple(self.values.shape))


def _host(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)
