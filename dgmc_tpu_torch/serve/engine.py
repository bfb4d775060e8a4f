"""Query path: route, pad, shortlist against the corpus table, rerank.

Each query runs the model's own forward
(:meth:`dgmc_tpu_torch.models.dgmc.DGMC.forward`) with the corpus ψ₁
table passed in precomputed (``h_t=...``): ψ₁ on the query, the top-k
shortlist against the device-resident table (the CUDA top-k kernel on
the card), the sparse consensus rerank and :func:`ranked`. On the card
:meth:`MatchEngine.warm` captures one CUDA graph of that whole query per
declared bucket (:mod:`~dgmc_tpu_torch.train.compiled`; the corpus graph,
``h_t`` and the weights are its fixed inputs, read in place); after it
returns the query path executes only: :meth:`MatchEngine.match` copies
the padded query into the bucket's buffers, replays the graph and copies
the answer to the host. A query that brings its own noise (``r_s``) is
served by a second graph for its bucket, captured at its first use. On
the CPU the same static-buffer code runs eagerly (``warm`` runs each
bucket once). ``jit=False`` runs every query eagerly (the comparison
``chip_smoke.py`` makes on the card).

Answers are bit-identical across repeats and across concurrent callers:
execution is serialized under one lock, the indicator noise comes from a
fixed seed, aggregation has a fixed summation order (``ops/graph.py``),
the kernel uses no atomics, and every ranking is a stable
lowest-index-first selection.

Corpus tiers (the JAX engine's):

- **device** (default): ``h_t`` on the device; the search runs inside the
  bucket's graph.
- **streamed**: the same, with the model's ``stream_chunk`` set: the
  search inside the graph runs over source chunks (one top-k launch per
  chunk).
- **offload** (``offload=True``): ``h_t`` stays in host RAM (pinned). A
  query runs in three parts: ψ₁ of the query (a captured graph per
  bucket), the host-driven shortlist
  :func:`~dgmc_tpu_torch.ops.offload.offloaded_corpus_topk` (target chunks
  of ``offload_chunk`` rows through the ``prefetch_depth``-deep ring, one
  top-k launch per chunk, eager: the loop is the host's), then the
  rerank, a second captured graph per bucket that takes the shortlist
  ``S_idx`` and the candidate rows ``h_t_cand`` (gathered on the host
  from the host table, checked against ``[0, N_t)`` there) as static
  inputs, as the JAX engine's rerank executable does. The device never
  holds more of the table than the ring's chunks and the candidates.

Each tier's answers are bit-identical to the device tier's.

Not ported: the shadow audit, the goodput/capacity accounting and the
HTTP front end.
"""

import threading
import time

import numpy as np
import torch

from dgmc_tpu_torch import resolve_device
from dgmc_tpu_torch.obs import probes
from dgmc_tpu_torch.obs.memory import captured_memory
from dgmc_tpu_torch.ops.graph import GraphBatch
from dgmc_tpu_torch.ops.offload import (DEFAULT_PREFETCH_DEPTH,
                                        offloaded_corpus_topk)
from dgmc_tpu_torch.ops.topk import stable_topk
from dgmc_tpu_torch.train.compiled import Fixed, compiled

__all__ = ['MatchEngine', 'UnknownExecutableError', 'ranked']


def ranked(S_0, S_L, node_mask, r):
    """The answer tensors of one query: the ``r`` best candidates of
    ``S_L`` per node, the initial top-1 of ``S_0``, and per-query
    confidence proxies (masked means over the real query nodes)."""
    vals, pos = stable_topk(S_L.val, S_L.val.shape[-1])
    top_v, top_p = vals[..., :r], pos[..., :r]
    top_i = torch.gather(S_L.idx, -1, top_p)
    v0, p0 = stable_topk(S_0.val, 1)
    i0 = torch.gather(S_0.idx, -1, p0)
    mask = node_mask.to(torch.float32)
    denom = mask.sum().clamp(min=1.0)

    def row_mean(x):
        return (x.to(torch.float32) * mask).sum() / denom

    k = S_L.val.shape[-1]
    # Degenerate shortlist of one: the margin is the full top-1 mass.
    margin = row_mean(vals[..., 0] - vals[..., 1] if k >= 2 else vals[..., 0])
    # Shortlist slots are ordered by the initial score, so the winning
    # slot is the selected match's rank inside the shortlist; rank k-1
    # means the answer sat on the shortlist boundary.
    sel_rank = pos[..., 0].to(torch.float32)
    saturated = ((pos[..., 0] == k - 1).to(torch.float32) if k > 1
                 else torch.zeros_like(sel_rank))
    return {'cand_idx': top_i, 'cand_prob': top_v,
            'initial_idx': i0[..., 0], 'initial_prob': v0[..., 0],
            'shortlist_idx': S_L.idx,
            'q_entropy': probes.entropy(S_L.val, node_mask),
            'q_margin': margin,
            'q_correction': probes.delta_norm(S_L.val, S_0.val, node_mask),
            'q_saturation': row_mean(sel_rank / max(k - 1, 1)),
            'q_saturated_frac': row_mean(saturated)}


class UnknownExecutableError(RuntimeError):
    """A routed bucket that was never warmed."""

    def __init__(self, bucket, sig):
        self.payload = {
            'error': 'bucket-not-warm',
            'detail': f'bucket {bucket.nodes}x{bucket.edges} (signature '
                      f'{sig}) was not warmed',
        }
        super().__init__(self.payload['detail'])


class MatchEngine:
    """Serve sparse DGMC matches of query graphs against one corpus index.

    Args:
        model: a sparse :class:`~dgmc_tpu_torch.models.dgmc.DGMC`; it is
            moved to ``device`` and put in eval mode.
        index: the :class:`~dgmc_tpu_torch.serve.corpus.CorpusIndex`.
        router: a :class:`~dgmc_tpu_torch.serve.router.QueryRouter` whose
            corpus shape matches ``index``.
        max_results: ranked candidates per query node (at most ``k``).
        noise_seed: every query draws its indicator noise from this fixed
            seed, so identical queries get identical answers.
        device: ``cuda`` by default; raises where CUDA is absent unless
            ``'cpu'`` is passed.
        jit: serve each bucket through its captured graph (the default);
            ``False`` runs every query eagerly.
        offload: the host-RAM corpus tier (see the module docstring);
            ``offload_chunk`` / ``prefetch_depth``: its target chunk and
            ring depth (``None``: ``ops/offload.DEFAULT_PREFETCH_DEPTH``).
            The streamed tier is the model's ``stream_chunk``.
    """

    def __init__(self, model, index, router, max_results=5, noise_seed=0,
                 device=None, jit=True, offload=False, offload_chunk=4096,
                 prefetch_depth=None):
        self.device = resolve_device(device)
        if router.corpus_nodes != index.corpus.num_nodes \
                or router.corpus_edges != index.corpus.num_edges:
            raise ValueError('the router\'s corpus shape differs from the '
                             'index\'s corpus')
        self.model = model.to(self.device).eval()
        self.index = index
        self.router = router
        self.max_results = int(min(max_results, model.k))
        self.noise_seed = int(noise_seed)
        self._lock = threading.Lock()
        self._t_graph = GraphBatch.from_numpy(index.corpus.graph_arrays(),
                                              self.device)
        self.offload = bool(offload)
        self.offload_chunk = int(offload_chunk)
        self.prefetch_depth = int(prefetch_depth or DEFAULT_PREFETCH_DEPTH)
        h_t = torch.as_tensor(index.h_t, dtype=torch.float32)
        if self.offload:
            # The host table in the compute dtype, as the model casts it.
            self._h_t = None
            self._h_t_host = model._cast(h_t).contiguous()
            if self.device.type == 'cuda':
                self._h_t_host = self._h_t_host.pin_memory()
        else:
            self._h_t = h_t.to(self.device)
        self._warm = {}   # signature -> {'bucket', 'warm_s', 'queries'}
        self._compiled = self._embed = None
        if jit:
            self._compiled = compiled(self._rerank if self.offload
                                      else self._query, self.device)
            if self.offload:
                self._embed = compiled(self._embed_query, self.device)
        self.last_offload = None
        self.query_count = 0
        self.last_latency_s = None

    def _template(self, bucket):
        """Zero-filled query arrays of the bucket's padded shape."""
        n, e = bucket.nodes, bucket.edges
        return {'x': np.zeros((1, n, self.index.corpus.feat_dim),
                              np.float32),
                'senders': np.zeros((1, e), np.int32),
                'receivers': np.zeros((1, e), np.int32),
                'node_mask': np.zeros((1, n), bool),
                'edge_mask': np.zeros((1, e), bool)}

    def warm(self):
        """Capture every declared bucket's graph (on the CPU: run it
        once); returns ``{signature: info}`` with each bucket's seconds
        (``warm_s``), those of its capture (``capture_s``, warm-up runs
        included; 0 without ``jit``) and its graph's static memory
        (``memory``, :func:`~dgmc_tpu_torch.obs.memory.captured_memory`;
        ``None`` without ``jit``)."""
        report = {}
        for bucket in self.router.buckets:
            sig = self.router.signature(bucket)
            t0 = time.perf_counter()
            with self._lock:
                rec = self._capture(self._template(bucket))
            warm_s = round(time.perf_counter() - t0, 3)
            self._warm[sig] = {'bucket': bucket, 'warm_s': warm_s,
                               'queries': 0}
            report[sig] = {
                'bucket': sig, 'warm_s': warm_s,
                'capture_s': round(rec.capture_s, 3) if rec else 0.0,
                'memory': captured_memory(rec) if rec else None}
        return report

    @property
    def buckets_warm(self):
        return len(self._warm)

    def bucket_stats(self):
        return {info['bucket']: info['queries']
                for info in self._warm.values()}

    def match(self, graph, r_s=None):
        """Answer one query :class:`~dgmc_tpu_torch.utils.data.Graph`.

        Routes, pads, executes and returns the structured answer (host
        Python). Raises :class:`~dgmc_tpu_torch.serve.router.
        UnknownBucketError` for a query outside the declared buckets and
        ``ValueError`` for a malformed one. Thread-safe; execution is
        serialized. ``r_s`` (``[num_steps, 1, bucket nodes, R_in]``)
        replaces the drawn indicator noise.
        """
        if graph.x is None:
            raise ValueError('query graphs need node features x')
        if graph.x.shape[1] != self.index.corpus.feat_dim:
            raise ValueError(
                f'query feature width {graph.x.shape[1]} != corpus '
                f'feature width {self.index.corpus.feat_dim}')
        n_real = graph.num_nodes
        bucket = self.router.route(n_real, graph.num_edges)
        sig = self.router.signature(bucket)
        info = self._warm.get(sig)
        if info is None:
            raise UnknownExecutableError(bucket, sig)
        arrays = self.router.pad_query(graph, bucket)
        with self._lock:
            t0 = time.perf_counter()
            out = self._execute(arrays, r_s)
            self.last_latency_s = time.perf_counter() - t0
            info['queries'] += 1
            self.query_count += 1
        return self._answer(bucket, n_real, out)

    def _query(self, model, q, t_graph, h_t, r_s):
        """The query path of one padded query: what a bucket's graph
        records (device and streamed tiers)."""
        S_0, S_L = model(q, t_graph, h_t=h_t, noise_seed=self.noise_seed,
                         r_s=r_s)
        return ranked(S_0, S_L, q.node_mask, self.max_results)

    def _embed_query(self, model, q):
        """ψ₁ of the query in the compute dtype (offload tier)."""
        return model._cast(model.psi_1(q.x, q))

    def _rerank(self, model, q, t_graph, S_idx, h_t_cand, r_s):
        """The rerank over a shortlist made outside the graph (offload
        tier), checked on the host before it was copied in."""
        S_0, S_L = model(q, t_graph, S_idx=S_idx, h_t_cand=h_t_cand,
                         noise_seed=self.noise_seed, r_s=r_s,
                         check_idx=False)
        return ranked(S_0, S_L, q.node_mask, self.max_results)

    def _shortlist(self, q):
        """The offload tier's host-driven part: ψ₁ of the query, the
        ring-fed search over the host table, the candidate rows gathered
        on the host → ``(S_idx, h_t_cand)`` host tensors."""
        if self._embed is not None:
            h_s = self._embed(Fixed(self.model), q)
        else:
            h_s = self._embed_query(self.model, q.to(self.device))
        _, idx, stats = offloaded_corpus_topk(
            h_s, self._h_t_host, self.model.k, self.offload_chunk,
            depth=self.prefetch_depth, device=self.device)
        self.last_offload = stats
        N_t = self._h_t_host.shape[1]
        if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= N_t):
            raise RuntimeError(f'offloaded shortlist outside [0, {N_t})')
        h_t_cand = self._h_t_host[0][idx[0].long()][None]
        return idx, h_t_cand

    def _inputs(self, arrays, r_s=None):
        """The compiled query's inputs: the padded query's host part
        (pinned for the card) and ``r_s`` are copied, the rest is read in
        place. The offload tier's rerank also takes the shortlist and the
        candidate rows, made here."""
        q = GraphBatch.host(arrays, pin_memory=self.device.type == 'cuda')
        if r_s is not None:
            r_s = torch.as_tensor(r_s, dtype=torch.float32)
        if self.offload:
            return (Fixed(self.model), q, Fixed(self._t_graph),
                    *self._shortlist(q), r_s)
        return (Fixed(self.model), q, Fixed(self._t_graph),
                Fixed(self._h_t), r_s)

    def _capture(self, arrays):
        """The bucket's record, built ahead of its first query (without
        ``jit``: one eager run, and ``None``). The offload tier captures
        the query's ψ₁ and the rerank, and runs the ring-fed search once
        between them."""
        if self._compiled is None:
            self._execute(arrays)
            return None
        with torch.inference_mode():
            return self._compiled.capture(*self._inputs(arrays))

    def _execute(self, arrays, r_s=None):
        """The answer arrays of one padded query."""
        with torch.inference_mode():
            inputs = self._inputs(arrays, r_s)
            if self._compiled is not None:
                out = self._compiled(*inputs)
            else:
                fn = self._rerank if self.offload else self._query
                out = fn(*(x.value if isinstance(x, Fixed) else
                           None if x is None else x.to(self.device)
                           for x in inputs))
            # Non-blocking copies into pinned host memory, then one wait:
            # the answer is complete here. Fresh host tensors: the next
            # replay overwrites the static outputs, not these.
            host = {k: v.to('cpu', non_blocking=True)
                    for k, v in out.items()}
            if self.device.type == 'cuda':
                torch.cuda.current_stream(self.device).synchronize()
            return {k: v.numpy() for k, v in host.items()}

    def _answer(self, bucket, n_real, out):
        matches = []
        for i in range(n_real):
            cands = [[int(t), float(p)] for t, p in
                     zip(out['cand_idx'][0, i], out['cand_prob'][0, i])]
            matches.append({
                'node': i,
                'target': cands[0][0],
                'score': cands[0][1],
                'candidates': cands,
                'initial': [int(out['initial_idx'][0, i]),
                            float(out['initial_prob'][0, i])],
            })
        return {
            'bucket': f'{bucket.nodes}x{bucket.edges}',
            'signature': self.router.signature(bucket),
            'nodes': n_real,
            'matches': matches,
            # Per-query confidence proxies (deterministic: the fixed
            # noise seed makes them a pure function of the query).
            'quality': {
                'entropy': round(float(out['q_entropy']), 6),
                'margin': round(float(out['q_margin']), 6),
                'correction': round(float(out['q_correction']), 6),
                'saturation': round(float(out['q_saturation']), 6),
                'saturated_frac': round(float(out['q_saturated_frac']),
                                        6),
            },
            # The shortlist each node was reranked over (plain ints, so
            # answers stay ==-comparable).
            'shortlist': [[int(t) for t in row]
                          for row in out['shortlist_idx'][0, :n_real]],
        }
