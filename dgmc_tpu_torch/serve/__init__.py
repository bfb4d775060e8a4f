"""Online matching: the corpus index, the bucket router, the match engine
and the serving worker.

- :mod:`~dgmc_tpu_torch.serve.corpus` — ψ₁ embeddings of the target
  corpus computed once and cached on disk under a sha256 manifest, so a
  restarted worker skips the recompute (the warm restart).
- :mod:`~dgmc_tpu_torch.serve.router` — padding-bucket routing; a query
  that fits no declared bucket is a structured 4xx.
- :mod:`~dgmc_tpu_torch.serve.engine` — one captured CUDA graph per
  bucket: ψ₁ on the query, the top-k shortlist against the corpus table
  (device-resident, streamed, or host-RAM offloaded), the consensus
  rerank; bit-identical answers across repeats, callers and tiers.
- :mod:`~dgmc_tpu_torch.serve.service` — the worker
  (``python -m dgmc_tpu_torch.serve``): ``/match`` beside the live
  plane's ``/healthz``, ``/metrics`` and ``/status``, supervised
  restarts through ``--supervise``.
- :mod:`~dgmc_tpu_torch.serve.audit` — the sampled shadow audit.
- :mod:`~dgmc_tpu_torch.serve.client` — query sampling, HTTP and
  endpoint discovery.
- :mod:`~dgmc_tpu_torch.serve.cli` — ``python -m
  dgmc_tpu_torch.serve.cli``: answer sampled queries at DBP15K width and
  exit.
"""

from dgmc_tpu_torch.serve.corpus import Corpus, CorpusIndex, synthetic_corpus
from dgmc_tpu_torch.serve.engine import MatchEngine
from dgmc_tpu_torch.serve.router import (QueryRouter, UnknownBucketError,
                                         parse_buckets)
from dgmc_tpu_torch.serve.service import ServeService, add_serve_args

__all__ = ['Corpus', 'CorpusIndex', 'synthetic_corpus', 'MatchEngine',
           'QueryRouter', 'UnknownBucketError', 'parse_buckets',
           'ServeService', 'add_serve_args']
