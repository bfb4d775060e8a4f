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

The engine keeps the JAX engine's saturation account
(:meth:`MatchEngine.capacity_stats`: the in-flight count, the lock's
wait and hold histograms, each bucket's pad fraction and goodput ratio,
the ratio weighted by the bucket's per-stage FLOPs, counted on its eager
forward at :meth:`MatchEngine.warm` (:mod:`~dgmc_tpu_torch.obs.cost`);
:mod:`~dgmc_tpu_torch.obs.capacity` models it), runs each phase of a
query under its span of the serve vocabulary when given a
:class:`~dgmc_tpu_torch.obs.qtrace.QueryTrace`, and with ``audit=True``
serves the shadow audit's exhaustive search
(:meth:`MatchEngine.exhaustive_topk`, :mod:`~dgmc_tpu_torch.serve.audit`)
on its own CUDA stream without taking the lock. The HTTP worker around
it is :mod:`~dgmc_tpu_torch.serve.service`.
"""

import contextlib
import threading
import time

import numpy as np
import torch

from dgmc_tpu_torch import resolve_device
from dgmc_tpu_torch.obs import goodput as goodput_mod
from dgmc_tpu_torch.obs.cost import cost_summary
from dgmc_tpu_torch.obs import probes
from dgmc_tpu_torch.obs.live import StreamingHistogram
from dgmc_tpu_torch.obs.memory import captured_memory
from dgmc_tpu_torch.obs.qtrace import QTRACE_LATENCY_BOUNDS
from dgmc_tpu_torch.ops.graph import GraphBatch
from dgmc_tpu_torch.ops.kernels import dispatch
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
        obs: optional :class:`~dgmc_tpu_torch.obs.run.RunObserver`: each
            bucket's capture is a compile event under the label
            ``serve_bucket_<N>x<E>``, logged as ``serve_warm_<label>``,
            and each query's execution is one observer step.
        audit: keep the host table the shadow audit's exhaustive search
            scans (:meth:`exhaustive_topk`).
    """

    def __init__(self, model, index, router, max_results=5, noise_seed=0,
                 device=None, jit=True, offload=False, offload_chunk=4096,
                 prefetch_depth=None, obs=None, audit=False):
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
        self._obs = obs
        self._lock = threading.Lock()
        self._t_graph = GraphBatch.from_numpy(index.corpus.graph_arrays(),
                                              self.device)
        self.offload = bool(offload)
        self.audit = bool(audit)
        self.offload_chunk = int(offload_chunk)
        self.prefetch_depth = int(prefetch_depth or DEFAULT_PREFETCH_DEPTH)
        h_t = torch.as_tensor(index.h_t, dtype=torch.float32)
        self._h_t = None if self.offload else h_t.to(self.device)
        self._h_t_host = None
        if self.offload or self.audit:
            # The host table in the compute dtype, as the model casts it:
            # the offload tier's corpus, and the audit's exhaustive scan.
            self._h_t_host = model._cast(h_t).contiguous()
            if self.device.type == 'cuda':
                self._h_t_host = self._h_t_host.pin_memory()
        # The audit's own stream: its search never waits behind, or
        # holds up, a query's replay on the default stream.
        self._audit_stream = (torch.cuda.Stream(self.device)
                              if self.audit and self.device.type == 'cuda'
                              else None)
        self._exec = {}   # signature -> per-bucket record
        self._compiled = self._embed = None
        if jit:
            self._compiled = compiled(self._rerank if self.offload
                                      else self._query, self.device)
            if self.offload:
                self._embed = compiled(self._embed_query, self.device)
        self.last_offload = None
        self.query_count = 0
        self.last_latency_s = None
        # The saturation account (obs.capacity's input): the in-flight
        # gauge and the engine lock split into wait and hold. The wait
        # histogram measures the region qtrace's admission_queue_wait
        # span wraps, for every query, traced or not; both use qtrace's
        # bounds so the two accounts quantize alike.
        self._stats_lock = threading.Lock()
        self.inflight = 0
        self.lock_wait_hist = StreamingHistogram(QTRACE_LATENCY_BOUNDS)
        self.lock_hold_hist = StreamingHistogram(QTRACE_LATENCY_BOUNDS)
        self._t_first_query = None
        self._t_last_query = None

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
            label = f'serve_bucket_{bucket.nodes}x{bucket.edges}'
            t0 = time.perf_counter()
            tpl = self._template(bucket)
            with (self._obs.compile_label(label) if self._obs
                  else contextlib.nullcontext()):
                with self._lock:
                    stages = self._stage_flops(tpl)
                    rec = self._capture(tpl)
            warm_s = round(time.perf_counter() - t0, 3)
            mem = captured_memory(rec) if rec else None
            self._exec[sig] = {'bucket': bucket, 'warm_s': warm_s,
                               'queries': 0, 'pad_sum': 0.0,
                               'goodput_sum': 0.0, 'stages': stages}
            report[sig] = {
                'bucket': f'{bucket.nodes}x{bucket.edges}',
                'warm_s': warm_s,
                'capture_s': round(rec.capture_s, 3) if rec else 0.0,
                'memory': mem}
            if self._obs:
                self._obs.log(0, event=f'serve_warm_{label}',
                              compile_s=warm_s,
                              capture_s=report[sig]['capture_s'],
                              **({'static_bytes': mem['total_bytes']}
                                 if mem else {}))
        return report

    def _stage_flops(self, arrays):
        """Per-stage FLOP table of one bucket's query
        (:func:`~dgmc_tpu_torch.obs.cost.cost_summary` of its eager
        forward on the template, before the capture): what the per-query
        goodput ratio composes with. The launch counters and the dispatch
        ledger are set back and nothing reaches the telemetry registry.
        ``None`` when the count fails: the ratio then falls back to the
        mask-only account."""
        ledger = dispatch.snapshot()
        try:
            with torch.inference_mode(), dispatch.quiet():
                q, r_s = self._stage(arrays)
                shortlist = None
                if self.offload:
                    idx = self._search(q)
                    shortlist = (idx, self._candidates(idx))
                args = [x.value if isinstance(x, Fixed) else
                        None if x is None else x.to(self.device)
                        for x in self._inputs(q, r_s, shortlist)]
                fn = self._rerank if self.offload else self._query
                return cost_summary(fn, *args)['stages'] or None
        except Exception:
            return None
        finally:
            dispatch.restore(ledger)

    @property
    def buckets_warm(self):
        return len(self._exec)

    def bucket_stats(self):
        return {info['bucket']: info['queries']
                for info in self._exec.values()}

    def capacity_stats(self):
        """The saturation and goodput account
        (:func:`~dgmc_tpu_torch.obs.capacity.live_summary`'s input): the
        in-flight count, the lock wait and hold histogram snapshots, the
        measured arrival window, and each bucket's pad-fraction and
        goodput-ratio running means."""
        with self._stats_lock:
            wait = self.lock_wait_hist.snapshot()
            hold = self.lock_hold_hist.snapshot()
            inflight = self.inflight
            t0, t1 = self._t_first_query, self._t_last_query
            buckets = {}
            pad_sum = good_sum = queries = 0
            for info in self._exec.values():
                b = info['bucket']
                q = info['queries']
                buckets[f'{b.nodes}x{b.edges}'] = {
                    'queries': q,
                    'pad_fraction': (round(info['pad_sum'] / q, 6)
                                     if q else None),
                    'goodput_ratio': (round(info['goodput_sum'] / q, 6)
                                      if q else None),
                    'stages_source': ('counted' if info.get('stages')
                                      else 'mask_only'),
                }
                pad_sum += info['pad_sum']
                good_sum += info['goodput_sum']
                queries += q
        window_s = (t1 - t0) if (t0 is not None and t1 is not None
                                 and t1 > t0) else None
        return {
            'inflight': inflight,
            'queries': queries,
            'window_s': round(window_s, 6) if window_s else None,
            'lock_wait': wait,
            'lock_hold': hold,
            'pad_fraction': (round(pad_sum / queries, 6)
                             if queries else None),
            'goodput_ratio': (round(good_sum / queries, 6)
                              if queries else None),
            'buckets': buckets,
        }

    def match(self, graph, trace=None, r_s=None):
        """Answer one query :class:`~dgmc_tpu_torch.utils.data.Graph`.

        Routes, pads, executes and returns the structured answer (host
        Python). Raises :class:`~dgmc_tpu_torch.serve.router.
        UnknownBucketError` for a query outside the declared buckets,
        :class:`UnknownExecutableError` for a bucket not warmed and
        ``ValueError`` for a malformed query. Thread-safe; execution is
        serialized. ``trace`` (a :class:`~dgmc_tpu_torch.obs.qtrace.
        QueryTrace`) times each phase under its serve span, the lock
        acquire included (``admission_queue_wait``). ``r_s``
        (``[num_steps, 1, bucket nodes, R_in]``) replaces the drawn
        indicator noise.
        """
        span = trace.span if trace is not None else contextlib.nullcontext
        with span('bucket_resolve'):
            if graph.x is None:
                raise ValueError('query graphs need node features x')
            if graph.x.shape[1] != self.index.corpus.feat_dim:
                raise ValueError(
                    f'query feature width {graph.x.shape[1]} != corpus '
                    f'feature width {self.index.corpus.feat_dim}')
            n_real = graph.num_nodes
            bucket = self.router.route(n_real, graph.num_edges)
            sig = self.router.signature(bucket)
            info = self._exec.get(sig)
            if info is None:
                raise UnknownExecutableError(bucket, sig)
        with span('pad_and_stage'):
            arrays = self.router.pad_query(graph, bucket)
        # The routed bucket against the query's real shape (the corpus
        # side is real by construction), composed with the bucket's
        # counted per-stage FLOPs.
        fills = goodput_mod.pair_fills(
            {'nodes_real': n_real, 'nodes_padded': bucket.nodes,
             'edges_real': graph.num_edges, 'edges_padded': bucket.edges},
            {'nodes_real': self.router.corpus_nodes,
             'nodes_padded': self.router.corpus_nodes,
             'edges_real': self.router.corpus_edges,
             'edges_padded': self.router.corpus_edges})
        good = goodput_mod.goodput_ratio(fills, info.get('stages'))
        with self._stats_lock:
            self.inflight += 1
        t_wait = time.perf_counter()
        with span('admission_queue_wait'):
            self._lock.acquire()
        t_hold = time.perf_counter()
        done = False
        try:
            step = (self._obs.step() if self._obs is not None
                    else contextlib.nullcontext())
            t0 = time.perf_counter()
            with step:
                out = self._execute(arrays, r_s, span)
            self.last_latency_s = time.perf_counter() - t0
            done = True
        finally:
            self._lock.release()
            t_done = time.perf_counter()
            with self._stats_lock:
                self.inflight -= 1
                self.lock_wait_hist.observe(t_hold - t_wait)
                self.lock_hold_hist.observe(t_done - t_hold)
                if self._t_first_query is None:
                    self._t_first_query = t_wait
                self._t_last_query = t_done
                if done:
                    # Answered queries only, the population `queries`
                    # counts.
                    info['queries'] += 1
                    self.query_count += 1
                    info['pad_sum'] += 1.0 - (n_real / bucket.nodes)
                    if good is not None:
                        info['goodput_sum'] += good
        with span('serialize'):
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

    def _search(self, q):
        """The offload tier's host-driven search: ψ₁ of the query, then
        the ring-fed search over the host table → the shortlist, a host
        ``[1, N, k]`` int32 tensor checked against ``[0, N_t)``."""
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
        return idx

    def _candidates(self, idx):
        """The shortlist's rows of the host table (offload tier)."""
        return self._h_t_host[0][idx[0].long()][None]

    @staticmethod
    def _stage(arrays, r_s=None, pin_memory=False):
        """The padded query's host tensors (pinned for the card) and
        ``r_s``, what a compiled call copies into its buffers."""
        q = GraphBatch.host(arrays, pin_memory=pin_memory)
        if r_s is not None:
            r_s = torch.as_tensor(r_s, dtype=torch.float32)
        return q, r_s

    def _inputs(self, q, r_s, shortlist=None):
        """The compiled query's inputs: ``q`` and ``r_s`` are copied, the
        rest is read in place; the offload tier's rerank also takes the
        shortlist and its candidate rows (``shortlist``)."""
        if self.offload:
            return (Fixed(self.model), q, Fixed(self._t_graph), *shortlist,
                    r_s)
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
            q, r_s = self._stage(arrays)
            shortlist = None
            if self.offload:
                idx = self._search(q)
                shortlist = (idx, self._candidates(idx))
            return self._compiled.capture(*self._inputs(q, r_s, shortlist))

    def _execute(self, arrays, r_s=None, span=contextlib.nullcontext):
        """The answer arrays of one padded query, each phase under its
        serve span."""
        with torch.inference_mode():
            with span('pad_and_stage'):
                q, r_s = self._stage(arrays, r_s,
                                     self.device.type == 'cuda')
            if not self.offload:
                with span('device_execute'):
                    return self._run(self._inputs(q, r_s))
            with span('device_execute'):
                idx = self._search(q)
            with span('shortlist_merge'):
                h_t_cand = self._candidates(idx)
            with span('consensus_rerank'):
                return self._run(self._inputs(q, r_s, (idx, h_t_cand)))

    def _run(self, inputs):
        """Run the query (replay its graph, or eagerly) and copy the
        answer to the host."""
        if self._compiled is not None:
            out = self._compiled(*inputs)
        else:
            fn = self._rerank if self.offload else self._query
            out = fn(*(x.value if isinstance(x, Fixed) else
                       None if x is None else x.to(self.device)
                       for x in inputs))
        # Non-blocking copies into pinned host memory, then one wait: the
        # answer is complete here. Fresh host tensors: the next replay
        # overwrites the static outputs, not these.
        host = {k: v.to('cpu', non_blocking=True) for k, v in out.items()}
        if self.device.type == 'cuda':
            torch.cuda.current_stream(self.device).synchronize()
        return {k: v.numpy() for k, v in host.items()}

    def exhaustive_topk(self, q_padded):
        """Exhaustive corpus top-k of one padded query (the router's
        arrays): the shadow audit's reference search. ψ₁ of the query
        runs eagerly (nothing is built: the bucket's capture built every
        kernel it reaches), then the offloaded search over the FULL host
        table, the same top-k kernel and tie-breaking as the shortlist.
        Takes no lock: on the card it runs on the engine's audit stream,
        from its own buffers, never from a bucket's static ones. Returns
        the ``[1, N, k]`` candidate indices (host NumPy)."""
        if self._h_t_host is None:
            raise RuntimeError('exhaustive_topk needs the host table: '
                               'build the engine with audit=True or '
                               'offload=True')
        stream = (torch.cuda.stream(self._audit_stream)
                  if self._audit_stream is not None
                  else contextlib.nullcontext())
        with torch.inference_mode(), stream:
            q = GraphBatch.from_numpy(q_padded, self.device)
            h_s = self._embed_query(self.model, q)
            _, idx, _ = offloaded_corpus_topk(
                h_s, self._h_t_host, self.model.k, self.offload_chunk,
                depth=self.prefetch_depth, device=self.device)
        return idx.numpy()

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
            # Popped by the HTTP layer before serialization: the served
            # shortlist rows the shadow audit compares against the
            # exhaustive search (plain ints, so answers stay
            # ==-comparable).
            '_audit': {'shortlist_idx': [
                [int(t) for t in row]
                for row in out['shortlist_idx'][0, :n_real]]},
        }
