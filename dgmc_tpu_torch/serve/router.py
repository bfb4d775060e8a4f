"""Padding-bucket query routing.

The bucket space is declared at startup (``--buckets 32x96,64x192``),
every declared bucket is warmed before the first query, and a query that
fits no declared bucket is a structured error
(:class:`UnknownBucketError`).

Executables are keyed on the bucket's signature: the recompile pass's
:func:`~dgmc_tpu_torch.analysis.recompile.bucket_signature` over the
bucket's telemetry row (:meth:`QueryRouter.bucket_row`, the row format
the collation records in ``timings.json``'s ``padding_buckets``), the
same 16-hex key the JAX package's router gives the same bucket. An
answer's ``bucket`` field stays the readable ``'NxE'``.
"""

import re
from typing import List, NamedTuple

from dgmc_tpu_torch.analysis.recompile import bucket_signature
from dgmc_tpu_torch.utils.data import pad_graphs

__all__ = ['Bucket', 'DEFAULT_BUCKETS', 'QueryRouter', 'UnknownBucketError',
           'parse_buckets']

#: The worker's declared buckets unless ``--buckets`` says otherwise.
DEFAULT_BUCKETS = ((16, 48), (32, 96), (64, 192))


class Bucket(NamedTuple):
    """One declared query padding bucket (source-side shape)."""
    nodes: int
    edges: int


class UnknownBucketError(Exception):
    """A query that fits no declared bucket; ``payload`` is the
    structured error a front end returns verbatim."""

    def __init__(self, nodes, edges, buckets):
        self.payload = {
            'error': 'unknown-bucket',
            'detail': f'query ({nodes} nodes, {edges} edges) fits no '
                      f'declared padding bucket',
            'query': {'nodes': int(nodes), 'edges': int(edges)},
            'buckets': [f'{b.nodes}x{b.edges}' for b in buckets],
        }
        super().__init__(self.payload['detail'])


def parse_buckets(spec) -> List[Bucket]:
    """``'32x96,64x192'`` → sorted, deduplicated bucket list."""
    out = set()
    for part in str(spec).split(','):
        part = part.strip()
        if not part:
            continue
        m = re.match(r'^(\d+)x(\d+)$', part)
        if not m:
            raise ValueError(f'bad bucket spec {part!r} (want NxE, e.g. '
                             f'32x96)')
        b = Bucket(int(m.group(1)), int(m.group(2)))
        if b.nodes < 1 or b.edges < 1:
            raise ValueError(f'bucket {part!r} must be positive')
        out.add(b)
    if not out:
        raise ValueError(f'no buckets in spec {spec!r}')
    return sorted(out)


class QueryRouter:
    """Route queries into declared padding buckets.

    Args:
        buckets: declared :class:`Bucket` list (or a ``'NxE,...'`` spec).
        corpus_nodes / corpus_edges: the fixed target-side shape every
            bucket pairs with.
    """

    def __init__(self, buckets, corpus_nodes, corpus_edges):
        if isinstance(buckets, str):
            buckets = parse_buckets(buckets)
        self.buckets = sorted(Bucket(int(n), int(e)) for n, e in buckets)
        self.corpus_nodes = int(corpus_nodes)
        self.corpus_edges = int(corpus_edges)

    def route(self, nodes, edges) -> Bucket:
        """Smallest declared bucket that fits (nodes, edges), by node
        padding then edge padding. No fit raises
        :class:`UnknownBucketError`."""
        for b in self.buckets:
            if nodes <= b.nodes and edges <= b.edges:
                return b
        raise UnknownBucketError(nodes, edges, self.buckets)

    def bucket_row(self, bucket) -> dict:
        """The padding-bucket row this bucket collates as (the run
        plane's ``padding_buckets`` format, B=1 against the corpus)."""
        return {'batch': 1,
                'nodes': f'{bucket.nodes}x{self.corpus_nodes}',
                'edges': f'{bucket.edges}x{self.corpus_edges}'}

    def signature(self, bucket) -> str:
        """The bucket's executable-table key: the recompile pass's
        signature hash of :meth:`bucket_row`."""
        return bucket_signature(self.bucket_row(bucket))

    def pad_query(self, graph, bucket):
        """Collate one host :class:`~dgmc_tpu_torch.utils.data.Graph` into
        ``bucket``'s padded arrays (B=1), counting the collation in the
        registry (the run plane's ``padding_buckets``) with the query's
        real sizes beside it; the corpus side is real by construction."""
        from dgmc_tpu_torch.obs.registry import record_padding
        record_padding(
            **self.bucket_row(bucket),
            real={'nodes_s': int(graph.num_nodes),
                  'edges_s': int(graph.num_edges),
                  'nodes_t': self.corpus_nodes,
                  'edges_t': self.corpus_edges})
        return pad_graphs([graph], bucket.nodes, bucket.edges)
