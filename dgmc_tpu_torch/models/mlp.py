"""Multi-layer perceptron backbone.

``num_layers`` linear maps (``lins.<i>``, flax's ``dense_<i>``); ReLU and
then the optional :class:`~dgmc_tpu_torch.models.norm.MaskedBatchNorm`
(``bns.<i>``, flax's ``bn_<i>``) between layers, never after the last;
dropout only before the last map. Works on padded ``[B, N, C]`` node
tensors; the node mask selects the batch-norm statistics' rows.

``dtype`` (a compute dtype or a precision policy): each linear map runs
in it as :func:`~dgmc_tpu_torch.models.rel.dense` does (flax ``Dense(
dtype=...)``); batch norm keeps float32 statistics and returns float32,
which the next map casts again.

Row-local: given a rank's block of the node rows (``rows``, a
:class:`~dgmc_tpu_torch.models.rel.NodeRows`) it computes those rows
only, its batch norm's statistics over every rank's real rows and its
dropout mask the whole graph's, cut to the block.
"""

from torch import nn

from dgmc_tpu_torch.models.norm import MaskedBatchNorm
from dgmc_tpu_torch.models.precision import compute_dtype_of
from dgmc_tpu_torch.models.rel import dense, dropout, init_linear_

__all__ = ['MLP']


class MLP(nn.Module):
    def __init__(self, in_channels, out_channels, num_layers,
                 batch_norm=False, dropout=0.0, dtype=None):
        super().__init__()
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.num_layers = num_layers
        self.batch_norm = batch_norm
        self.dropout = dropout
        self.dtype = compute_dtype_of(dtype)
        self.lins = nn.ModuleList(
            nn.Linear(in_channels if i == 0 else out_channels, out_channels)
            for i in range(num_layers))
        self.bns = nn.ModuleList(
            MaskedBatchNorm(out_channels) for _ in range(num_layers - 1)
        ) if batch_norm else None

    def reset_parameters(self, generator=None):
        for lin in self.lins:
            init_linear_(lin, generator)
        for bn in self.bns or ():
            bn.reset_parameters()

    def forward(self, x, node_mask=None, generator=None, rows=None):
        """``generator``: the source of the dropout mask, needed in
        training mode with ``dropout > 0``. ``rows``: ``x`` and
        ``node_mask`` are this rank's block of the node rows (see the
        module docstring)."""
        if rows is not None:
            generator = rows.dropout_source(generator)
        for i, lin in enumerate(self.lins):
            last = i == self.num_layers - 1
            if last and self.training and self.dropout > 0:
                x = dropout(x, self.dropout, generator)
            x = dense(lin, x, self.dtype)
            if not last:
                x = x.relu()
                if self.batch_norm:
                    x = self.bns[i](x, node_mask, rows=rows)
        return x

    def extra_repr(self):
        return (f'{self.in_channels}, {self.out_channels}, '
                f'num_layers={self.num_layers}, '
                f'batch_norm={self.batch_norm}, dropout={self.dropout}')
