"""The serving worker: checkpoint → cache → warm buckets → answer.

The port of the JAX package's ``dgmc_tpu/serve/service.py``.
``ServeService`` owns the worker lifecycle:

1. build or load the corpus (synthetic by spec, or an ``.npz``),
2. restore the checkpoint (:mod:`~dgmc_tpu_torch.train.checkpoint`;
   ``--init-missing`` seeds and saves step 0 into an empty directory so
   runs are self-contained and deterministic across supervised
   restarts),
3. load or build the ψ₁ corpus cache (sha256-manifested; a verified
   hit is the warm restart path, logged and exported as the
   ``corpus_cache_hit`` gauge),
4. capture every declared bucket's CUDA graph
   (:meth:`~dgmc_tpu_torch.serve.engine.MatchEngine.warm`; graphs do not
   outlive the process, so a warm restart captures again),
5. serve ``/match`` beside ``/healthz``, ``/metrics`` and ``/status`` on
   the observer's telemetry plane, with per-query latency in the
   Prometheus histogram (``dgmc_step_latency_seconds``: a "step" is a
   query here), the per-query trace (:mod:`~dgmc_tpu_torch.obs.qtrace`),
   the capacity account (:mod:`~dgmc_tpu_torch.obs.capacity`) and the
   shadow audit (:mod:`~dgmc_tpu_torch.serve.audit`).

The plane answers each request on its own thread; the engine serializes
execution under its lock, so a bucket's graph is replayed, its inputs
copied in and its answer copied out in stream order whichever thread
asks.

Run supervised through ``python -m dgmc_tpu_torch.serve --supervise``
(:mod:`~dgmc_tpu_torch.resilience.supervisor`): the monitor kills a
wedged worker on the same ``/healthz`` verdict the plane serves, and the
restarted worker comes back warm from the cache. The idle loop beats the
watchdog: an idle server is healthy; only a wedged one goes stale.
"""

import argparse
import collections
import json
import os
import signal
import sys
import threading
import time

import numpy as np

from dgmc_tpu_torch.obs.qtrace import QueryTracer
from dgmc_tpu_torch.obs.run import add_obs_flag
from dgmc_tpu_torch.resilience.supervisor import add_supervisor_args
from dgmc_tpu_torch.serve.router import (DEFAULT_BUCKETS, QueryRouter,
                                         UnknownBucketError, parse_buckets)

__all__ = ['ServeService', 'add_serve_args', 'main', 'ERROR_CLASSES']

#: Per-class query-error labels in the Prometheus exposition
#: (``dgmc_query_errors_total{class=...}``): HTTP code + cause, every
#: class pre-seeded at 0 so scrapers always see the full label set.
ERROR_CLASSES = ('bad-query-400', 'bucket-miss-400', 'method-405',
                 'engine-500', 'warming-503', 'bucket-not-warm-503')


def add_serve_args(parser):
    """The serving CLI surface (``python -m dgmc_tpu_torch.serve``): the
    JAX worker's flags and defaults, plus ``--device``."""
    parser.add_argument('--ckpt_dir', '--ckpt-dir', dest='ckpt_dir',
                        type=str, required=True,
                        help='checkpoint directory (train/checkpoint.py '
                             'layout); the serving weights')
    parser.add_argument('--init-missing', '--init_missing',
                        dest='init_missing', action='store_true',
                        help='if the checkpoint directory is empty, '
                             'initialize seeded parameters and SAVE them '
                             'as step 0 before serving — self-contained '
                             'smoke/bench runs whose supervised restarts '
                             'restore identical weights')
    parser.add_argument('--corpus-npz', '--corpus_npz', dest='corpus_npz',
                        type=str, default=None,
                        help='corpus arrays: .npz with x [N,C] float32, '
                             'senders [E] int32, receivers [E] int32 '
                             '(default: synthetic by the --corpus-* '
                             'flags)')
    parser.add_argument('--corpus-nodes', '--corpus_nodes',
                        dest='corpus_nodes', type=int, default=4096)
    parser.add_argument('--corpus-edges', '--corpus_edges',
                        dest='corpus_edges', type=int, default=16384)
    parser.add_argument('--corpus-dim', '--corpus_dim', dest='corpus_dim',
                        type=int, default=64,
                        help='synthetic corpus feature width (and the '
                             'width every query must ship)')
    parser.add_argument('--corpus-seed', '--corpus_seed',
                        dest='corpus_seed', type=int, default=0)
    parser.add_argument('--cache-dir', '--cache_dir', dest='cache_dir',
                        type=str, default=None,
                        help='ψ₁ corpus-cache directory (default '
                             '<ckpt_dir>/corpus_cache; "" disables '
                             'caching — every restart is cold)')
    parser.add_argument('--buckets', type=str,
                        default=','.join(f'{n}x{e}'
                                         for n, e in DEFAULT_BUCKETS),
                        help='declared query padding buckets '
                             '"NxE,NxE,..." — each gets a captured '
                             'graph at startup; queries outside '
                             'the declared space get a structured 4xx '
                             '(default %(default)s)')
    parser.add_argument('--dim', type=int, default=64,
                        help='ψ₁ hidden width')
    parser.add_argument('--rnd_dim', type=int, default=16)
    parser.add_argument('--num_layers', type=int, default=2)
    parser.add_argument('--num_steps', type=int, default=4,
                        help='consensus rerank iterations per query')
    parser.add_argument('--k', type=int, default=10,
                        help='shortlist size (candidates reranked per '
                             'query node)')
    parser.add_argument('--max-results', '--max_results',
                        dest='max_results', type=int, default=5,
                        help='ranked candidates returned per node')
    parser.add_argument('--stream-chunk', '--stream_chunk',
                        dest='stream_chunk', type=int, default=0,
                        help='stream the shortlist search over source '
                             'chunks of this many rows (0 = off)')
    parser.add_argument('--offload-corpus', '--offload_corpus',
                        dest='offload_corpus', action='store_true',
                        help='host-RAM corpus tier: the ψ₁ table stays '
                             'in host memory; the shortlist streams '
                             'target chunks through the prefetch ring '
                             '(ops/offload.offloaded_corpus_topk) and '
                             'the rerank graph receives the '
                             'shortlist + candidate rows — device '
                             'residents stay O(corpus edges + query), '
                             'whatever the corpus row count')
    parser.add_argument('--offload-chunk', '--offload_chunk',
                        dest='offload_chunk', type=int, default=4096)
    parser.add_argument('--prefetch-depth', '--prefetch_depth',
                        dest='prefetch_depth', type=int, default=0,
                        help='prefetch ring depth for --offload-corpus '
                             '(0 = library default)')
    parser.add_argument('--noise-seed', '--noise_seed', dest='noise_seed',
                        type=int, default=0,
                        help='fixed consensus indicator-noise seed: '
                             'serving is deterministic — identical '
                             'queries get bit-identical answers')
    parser.add_argument('--seed', type=int, default=0,
                        help='weight-initialization seed (--init-missing) '
                             'and the qtrace / audit hash seed')
    parser.add_argument('--qtrace-sample', '--qtrace_sample',
                        dest='qtrace_sample', type=float, default=0.05,
                        help='deterministic keep fraction for per-query '
                             'span trees beyond the slowest-K reservoir '
                             'and errors (hash of seed+trace id, not '
                             'random; default %(default)s)')
    parser.add_argument('--qtrace-slowest', '--qtrace_slowest',
                        dest='qtrace_slowest', type=int, default=8,
                        help='always-keep reservoir: the K slowest '
                             'queries (default %(default)s)')
    parser.add_argument('--qtrace-capacity', '--qtrace_capacity',
                        dest='qtrace_capacity', type=int, default=256,
                        help='sampled-ring bound; qtrace.jsonl holds at '
                             'most capacity + error ring + K records '
                             '(default %(default)s)')
    parser.add_argument('--slo-ms', '--slo_ms', dest='slo_ms',
                        type=float, default=0.0,
                        help='end-to-end query SLO in ms; a breaching '
                             'query dumps the flight recorder with its '
                             'span tree attached (0 = off)')
    parser.add_argument('--min-margin', '--min_margin',
                        dest='min_margin', type=float, default=0.0,
                        help='low-confidence floor on the per-query '
                             'top-1/top-2 margin: a served answer whose '
                             'margin falls below it dumps the flight '
                             'recorder with the offending query attached '
                             '(0 = off)')
    parser.add_argument('--audit-sample', '--audit_sample',
                        dest='audit_sample', type=float, default=0.0,
                        help='shadow-audit keep fraction: that share of '
                             'live queries (deterministic hash of '
                             'seed+trace id) is re-scored through the '
                             'exhaustive corpus scan off the hot lock, '
                             'and shortlist recall@k against the served '
                             'answer lands in quality.json — on the '
                             'exact tiers recall must be 1.0 (0 = off)')
    parser.add_argument('--device', default=None,
                        help="torch device (default cuda; 'cpu' runs the "
                             'plain PyTorch path)')
    add_obs_flag(parser)
    add_supervisor_args(parser)
    return parser


def _load_corpus(args):
    from dgmc_tpu_torch.serve.corpus import Corpus, synthetic_corpus
    if args.corpus_npz:
        d = np.load(args.corpus_npz)
        return Corpus(x=np.asarray(d['x'], np.float32),
                      senders=np.asarray(d['senders'], np.int32),
                      receivers=np.asarray(d['receivers'], np.int32))
    return synthetic_corpus(args.corpus_nodes, args.corpus_edges,
                            args.corpus_dim, seed=args.corpus_seed)


class ServeService:
    """One serving worker (construct, :meth:`start`, :meth:`serve_forever`
    or drive in-process from tests via :attr:`port`/:meth:`stop`)."""

    def __init__(self, args):
        self.args = args
        self.engine = None
        self.obs = None
        self.port = None
        self.ready = False
        self.phases = {}
        self.queries_served = 0
        self.query_errors = collections.Counter(
            {cls: 0 for cls in ERROR_CLASSES})
        # Handler threads (ThreadingHTTPServer: one per request) bump
        # these outside the engine's execution lock — the non-atomic
        # += needs its own lock or concurrent clients lose increments.
        self._counts = threading.Lock()
        self._stop = threading.Event()
        self.low_confidence = 0
        # Flush-loop-private QPS bookmark (only serve_forever touches
        # it; queries_served itself stays under _counts).
        self._last_flush_queries = 0
        self.auditor = None
        self.qtracer = None
        if getattr(args, 'obs_dir', None):
            slo_ms = getattr(args, 'slo_ms', 0.0) or 0.0
            self.qtracer = QueryTracer(
                path=os.path.join(args.obs_dir, 'qtrace.jsonl'),
                sample_rate=getattr(args, 'qtrace_sample', 0.05),
                slowest_k=getattr(args, 'qtrace_slowest', 8),
                capacity=getattr(args, 'qtrace_capacity', 256),
                seed=getattr(args, 'seed', 0),
                slo_s=(slo_ms / 1e3) if slo_ms > 0 else None,
                on_breach=self._on_slo_breach)

    # -- startup -----------------------------------------------------------

    def start(self):
        args = self.args
        t_start = time.perf_counter()

        from dgmc_tpu_torch import resolve_device, set_exact_float32
        from dgmc_tpu_torch.obs import RunObserver
        self.device = resolve_device(getattr(args, 'device', None))
        set_exact_float32()
        # The observer comes up FIRST: warm-up captures must be counted
        # (the no-capture-per-query check is a delta against them), the
        # watchdog must cover the startup phases, and /healthz must
        # answer while the cache builds. /match answers 503 until ready.
        self.obs = RunObserver(args.obs_dir,
                               watchdog_deadline_s=args.watchdog_deadline,
                               obs_port=args.obs_port,
                               routes={'/match': self.handle_match})
        self.obs.add_metrics_provider(self._serve_metric_families)
        # SLO/anomaly planes: --slo judges every query against the
        # declared objectives (error budget + burn rates in /metrics,
        # /status and slo.json); the anomaly watch is always on —
        # query latency, QPS, compile events and quality margins feed
        # streaming detectors that arm the flight recorder. A
        # malformed --slo file fails startup here, loudly.
        self.obs.attach_anomaly()
        self.obs.attach_slo(getattr(args, 'slo', None))
        self.port = self.obs.live_port
        obs = self.obs

        def phase(name, fn):
            t0 = time.perf_counter()
            if obs.watchdog is not None:
                obs.watchdog.beat('serve-startup', name)
            out = fn()
            self.phases[f'{name}_s'] = round(time.perf_counter() - t0, 3)
            if obs.watchdog is not None:
                obs.watchdog.done()
            return out

        corpus = phase('corpus', lambda: _load_corpus(args))
        model, step = phase('checkpoint', lambda: self._restore(corpus))
        index, cache_info = phase(
            'cache', lambda: self._index(corpus, model, step))
        self.cache_info = cache_info

        router = QueryRouter(parse_buckets(args.buckets),
                             corpus.num_nodes, corpus.num_edges)
        from dgmc_tpu_torch.serve.engine import MatchEngine
        audit_rate = getattr(args, 'audit_sample', 0.0) or 0.0
        self.engine = MatchEngine(
            model, index, router,
            max_results=args.max_results, noise_seed=args.noise_seed,
            device=self.device, offload=args.offload_corpus,
            offload_chunk=args.offload_chunk,
            prefetch_depth=args.prefetch_depth or None, obs=obs,
            audit=audit_rate > 0)
        warm_report = phase('warm', self.engine.warm)
        # CUDA graphs do not outlive their process: a warm restart hits
        # the corpus cache and captures again. The captures' seconds,
        # apart from the cache's:
        self.phases['capture_s'] = round(
            sum(r['capture_s'] for r in warm_report.values()), 3)

        if obs.quality is not None and audit_rate > 0:
            obs.quality.set_audit_params(audit_rate,
                                         getattr(args, 'seed', 0))
        if audit_rate > 0:
            from dgmc_tpu_torch.serve.audit import ShadowAuditor
            self.auditor = ShadowAuditor(
                self.engine, obs.quality, sample_rate=audit_rate,
                seed=getattr(args, 'seed', 0))
        # One scrape answers "how fast AND how good": the qtrace
        # summary joins /status beside the observer's own quality block.
        if self.qtracer is not None:
            obs.add_status_section('qtrace', self.qtracer.summary)
        # And "how much headroom": the live queueing model over the
        # engine's saturation account (obs.capacity.live_summary).
        obs.add_status_section('capacity', self._capacity_status)
        if obs.quality is not None:
            obs.add_metrics_provider(obs.quality.metric_families)

        self.phases['ready_s'] = round(time.perf_counter() - t_start, 3)
        cache_hit = cache_info['cache'] == 'hit'
        obs.set_gauge('serve_ready', 1)
        obs.set_gauge('corpus_cache_hit', 1 if cache_hit else 0)
        obs.set_gauge('serve_buckets_warm', self.engine.buckets_warm)
        obs.set_gauge('queries_served', 0)
        obs.set_gauge('low_confidence_breaches', 0)
        if self.auditor is not None:
            obs.set_gauge('audited_queries', 0)
        warm_compiles = self._compile_events()
        obs.set_gauge('serve_warmup_compiles', warm_compiles)
        obs.log(0, event='serve_ready', cache=cache_info['cache'],
                cache_seconds=cache_info['seconds'],
                warmup_compiles=warm_compiles,
                buckets=len(warm_report), **self.phases)
        self.ready = True
        print(f'serve: ready in {self.phases["ready_s"]:.2f}s '
              f'(cache {cache_info["cache"]}, '
              f'{self.engine.buckets_warm} buckets warm, '
              f'{warm_compiles} warmup compiles) on port {self.port} '
              f'({self.device})',
              file=sys.stderr, flush=True)
        return self

    def _restore(self, corpus):
        """The DGMC of the flags (ψ₁ ``RelCNN(corpus_dim → dim)``, ψ₂
        ``RelCNN(rnd_dim)``) restored from the newest good step under
        ``--ckpt_dir`` (parameters and buffers, strict). An empty
        directory exits unless ``--init-missing``, which saves the
        weights seeded from ``--seed`` as step 0 first, so supervised
        restarts restore the same weights."""
        import torch

        from dgmc_tpu_torch.models.dgmc import DGMC
        from dgmc_tpu_torch.models.rel import RelCNN
        from dgmc_tpu_torch.train.checkpoint import Checkpointer
        from dgmc_tpu_torch.train.state import create_train_state
        args = self.args
        psi_1 = RelCNN(corpus.feat_dim, args.dim, args.num_layers,
                       batch_norm=False, cat=True, lin=True, dropout=0.0)
        psi_2 = RelCNN(args.rnd_dim, args.rnd_dim, args.num_layers,
                       batch_norm=False, cat=True, lin=True, dropout=0.0)
        model = DGMC(psi_1, psi_2, num_steps=args.num_steps, k=args.k,
                     generator=torch.Generator().manual_seed(args.seed))
        model.stream_chunk = args.stream_chunk or None
        ckpt = Checkpointer(args.ckpt_dir)
        if not ckpt.all_steps():
            if not args.init_missing:
                raise SystemExit(
                    f'serve: no checkpoint under {args.ckpt_dir} (pass '
                    f'--init-missing to seed-initialize and save step 0)')
            ckpt.save(0, model, create_train_state(model), wait=True)
        ckpt.restore(model)
        ckpt.close()
        return model.to(self.device).eval(), ckpt.restored_step

    def _index(self, corpus, model, step):
        from dgmc_tpu_torch.serve.corpus import load_or_build
        args = self.args
        cache_dir = args.cache_dir
        if cache_dir is None:
            cache_dir = os.path.join(args.ckpt_dir, 'corpus_cache')
        return load_or_build(
            cache_dir or None, model.psi_1, corpus, device=self.device,
            checkpoint_step=step,
            log=lambda m: print(f'serve: {m}', file=sys.stderr,
                                flush=True))

    def _compile_events(self):
        w = self.obs._watcher
        return (w.summary() or {}).get('events', 0) if w else 0

    def _count_error(self, cls):
        with self._counts:
            self.query_errors[cls] += 1

    def _on_slo_breach(self, record):
        """SLO-breach hook: dump the flight recorder NOW with the
        offending span tree attached — the trailing run context and
        the slow query's own decomposition in one artifact."""
        obs = self.obs
        if obs is not None:
            obs.flight_dump('slo-breach', extra={'qtrace': record})

    def _serve_metric_families(self):
        """Serve-plane metric families for the observer's ``/metrics``
        exposition: per-class error counters, the qtrace per-stage
        histograms and retention counters, and the capacity/goodput
        plane (in-flight gauge, lock wait/hold histograms, per-bucket
        pad fraction, goodput ratio)."""
        with self._counts:
            errors = dict(self.query_errors)
        families = [(
            'dgmc_query_errors_total', 'counter',
            'Query errors by class (HTTP code + cause).',
            [('', {'class': cls}, errors.get(cls, 0))
             for cls in ERROR_CLASSES])]
        if self.qtracer is not None:
            families.extend(self.qtracer.metric_families())
        if self.engine is not None:
            families.extend(self._capacity_metric_families())
        return families

    def _capacity_metric_families(self):
        """The saturation/goodput families. Families are always
        present once the engine is up (a scraper sees the full set
        from the first scrape); per-bucket pad-fraction samples appear
        as buckets answer queries, and the goodput gauge appears with
        the first measured ratio — absent measurements are absent, not
        zero."""
        from dgmc_tpu_torch.obs.live import histogram_family
        cap = self.engine.capacity_stats()
        pad_samples = [
            ('', {'bucket': name}, row['pad_fraction'])
            for name, row in sorted((cap.get('buckets') or {}).items())
            if row.get('pad_fraction') is not None]
        good_samples = ([('', {}, cap['goodput_ratio'])]
                        if cap.get('goodput_ratio') is not None else [])
        return [
            ('dgmc_inflight', 'gauge',
             'Queries currently inside the engine (admitted, waiting '
             'for or holding the execution lock).',
             [('', {}, cap.get('inflight', 0))]),
            ('dgmc_pad_fraction', 'gauge',
             'Mean padded-away node fraction per routed bucket '
             '(router bucket vs real query shape).', pad_samples),
            ('dgmc_goodput_ratio', 'gauge',
             'Useful FLOPs / executed FLOPs across answered queries '
             '(obs.goodput, weighted by each bucket\'s counted '
             'per-stage FLOPs).',
             good_samples),
            histogram_family(
                'dgmc_lock_wait_seconds',
                'Engine lock wait (the admission_queue_wait region, '
                'every query — traced or not).', cap['lock_wait']),
            histogram_family(
                'dgmc_lock_hold_seconds',
                'Engine lock hold (service time of the serialized '
                'executor).', cap['lock_hold']),
        ]

    def _capacity_status(self):
        """The `/status` ``capacity`` section: the live queueing model
        (obs.capacity) over the engine's saturation account, with the
        lock-wait distribution reconciled against qtrace's
        ``admission_queue_wait`` stage."""
        from dgmc_tpu_torch.obs.capacity import live_summary
        return live_summary(
            self.engine.capacity_stats(),
            qtrace_summary=(self.qtracer.summary()
                            if self.qtracer is not None else None))

    # -- the /match route --------------------------------------------------

    def handle_match(self, method, body, headers=None):
        """``(method, body bytes, headers) -> (code, payload[,
        headers])`` for the plane's route table. Every failure is
        structured AND counted per class: 405 wrong method, 503 warming
        up / bucket not warm, 400 malformed / unknown bucket, 500
        engine fault.

        Every request gets a trace: the W3C ``traceparent`` header is
        adopted when present (and echoed back in the response headers),
        otherwise a deterministic id is minted. Successful answers
        carry ``trace_id`` + per-stage ``stages_ms`` + the end-to-end
        ``trace_ms``; the ``x-qtrace: off`` header opts one request out
        entirely (the overhead-measurement path)."""
        headers = headers or {}
        tracer = self.qtracer
        if tracer is not None and str(
                headers.get('x-qtrace', '')).lower() in ('off', '0',
                                                         'false'):
            tracer = None
        trace = tracer.start(headers.get('traceparent')) \
            if tracer is not None else None
        t0 = time.perf_counter()
        code, payload = self._match_inner(method, body, trace)
        self._record_slo(code, time.perf_counter() - t0,
                         trace.stage_ms()
                         if trace is not None and code == 200 else None)
        if trace is None:
            return code, payload
        record = tracer.finish(
            trace, status=code,
            bucket=payload.get('bucket') if code == 200 else None,
            error=None if code == 200 else payload.get('error'))
        payload['trace_id'] = trace.trace_id
        if code == 200:
            payload['stages_ms'] = trace.stage_ms()
            payload['trace_ms'] = record['total_ms']
        tracer.maybe_flush()
        return code, payload, {
            'traceparent': trace.response_traceparent()}

    def _record_slo(self, code, latency_s, stages_ms):
        """Feed one query outcome to the SLO/anomaly planes. Client
        faults (400/405) are not service unavailability — the service
        answered correctly; 5xx and the warming/not-warm 503s are."""
        obs = self.obs
        if obs is None:
            return
        if obs.slo is not None:
            obs.slo.record(code < 500 and code != 503,
                           latency_s=latency_s, stages_ms=stages_ms)
        if obs.anomaly is not None:
            obs.anomaly.observe('query_latency_s', latency_s)

    def _match_inner(self, method, body, trace):
        if method != 'POST':
            self._count_error('method-405')
            return 405, {'error': 'POST a JSON query to /match',
                         'schema': {'nodes': '[[feat,...],...]',
                                    'edges': '[[src,dst],...]'}}
        if not self.ready:
            self._count_error('warming-503')
            return 503, {'error': 'warming-up',
                         'phases': dict(self.phases)}
        try:
            payload = json.loads(body.decode('utf-8'))
            from dgmc_tpu_torch.utils.data import Graph
            x = np.asarray(payload['nodes'], np.float32)
            edges = np.asarray(payload.get('edges') or [], np.int64)
            edges = (edges.T if edges.size
                     else np.zeros((2, 0), np.int64))
            if x.ndim != 2:
                raise ValueError(f'nodes must be [N, C], got shape '
                                 f'{x.shape}')
            graph = Graph(edge_index=edges, x=x)
        except (ValueError, KeyError, TypeError,
                UnicodeDecodeError) as e:
            self._count_error('bad-query-400')
            return 400, {'error': 'bad-query',
                         'detail': f'{type(e).__name__}: {e}'}
        t0 = time.perf_counter()
        from dgmc_tpu_torch.serve.engine import UnknownExecutableError
        try:
            answer = self.engine.match(graph, trace=trace)
        except UnknownBucketError as e:
            self._count_error('bucket-miss-400')
            return 400, e.payload
        except UnknownExecutableError as e:
            self._count_error('bucket-not-warm-503')
            return 503, e.payload
        except ValueError as e:
            self._count_error('bad-query-400')
            return 400, {'error': 'bad-query',
                         'detail': f'{type(e).__name__}: {e}'}
        except Exception as e:       # noqa: BLE001 — counted 500
            self._count_error('engine-500')
            return 500, {'error': 'engine-fault',
                         'detail': f'{type(e).__name__}: {e}'}
        with self._counts:
            self.queries_served += 1
            served = self.queries_served
        self.obs.set_gauge('queries_served', served)
        audit_info = answer.pop('_audit', None)
        self._observe_quality(answer, graph, trace, audit_info)
        answer['latency_ms'] = round(
            (time.perf_counter() - t0) * 1e3, 3)
        return 200, answer

    def _observe_quality(self, answer, graph, trace, audit_info):
        """Quality-plane bookkeeping for one served answer: histogram
        the confidence proxies, fire the --min-margin breach hook, and
        hand the sampled query to the shadow auditor."""
        quality = answer.get('quality') or {}
        tracker = self.obs.quality
        if tracker is not None and quality:
            tracker.observe_query(quality)
        min_margin = getattr(self.args, 'min_margin', 0.0) or 0.0
        margin = quality.get('margin')
        if margin is not None and self.obs.anomaly is not None:
            # Accuracy drift watch: a sustained confidence-margin slide
            # (CUSUM) arms the flight recorder even when no single
            # answer crosses the --min-margin floor.
            self.obs.anomaly.observe('quality_margin', margin)
        if min_margin > 0 and margin is not None \
                and margin < min_margin:
            with self._counts:
                self.low_confidence += 1
                breaches = self.low_confidence
            if tracker is not None:
                tracker.record_low_confidence()
            self.obs.set_gauge('low_confidence_breaches', breaches)
            # The qtrace SLO pattern applied to accuracy: dump the
            # flight recorder NOW, with the under-confident query
            # attached — trailing run context + the offending answer's
            # own confidence decomposition in one artifact.
            self.obs.flight_dump('low-confidence', extra={
                'quality': dict(quality),
                'min_margin': min_margin,
                'query': {'bucket': answer.get('bucket'),
                          'nodes': answer.get('nodes'),
                          'trace_id': (trace.trace_id
                                       if trace is not None else None)},
            })
        if self.auditor is not None and trace is not None \
                and audit_info is not None:
            self.auditor.maybe_submit(trace.trace_id, graph, audit_info)

    # -- lifecycle ---------------------------------------------------------

    def serve_forever(self, poll_s=0.5, flush_every_s=5.0):
        """Idle loop until SIGTERM/SIGINT/:meth:`stop`: beats the
        watchdog (an idle server is healthy) and periodically flushes
        the obs artifacts so the latest query telemetry is on disk for
        scrapers of the FILE artifacts too."""
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, lambda *_: self._stop.set())
            except ValueError:
                break
        last_flush = time.time()
        while not self._stop.is_set():
            self._stop.wait(poll_s)
            if self.obs.watchdog is not None:
                self.obs.watchdog.beat('idle')
            if time.time() - last_flush >= flush_every_s:
                if self.auditor is not None:
                    self.obs.set_gauge('audited_queries',
                                       self.auditor.audited)
                if self.obs.anomaly is not None:
                    # Demand-shape watch: served-QPS per flush window.
                    # A traffic cliff (deploy gone wrong upstream) or
                    # surge shifts this series and arms the recorder.
                    with self._counts:
                        served = self.queries_served
                    elapsed = max(time.time() - last_flush, 1e-9)
                    self.obs.anomaly.observe(
                        'qps',
                        (served - self._last_flush_queries) / elapsed)
                    self._last_flush_queries = served
                self.obs.flush()
                self._flush_capacity()
                if self.qtracer is not None:
                    self.qtracer.flush()
                last_flush = time.time()
        self.close()
        return 0

    def stop(self):
        self._stop.set()

    def close(self):
        if self.auditor is not None:
            # Finish the queued audits so the final quality.json and
            # gauges carry the complete account, then stop the thread.
            self.auditor.drain(timeout_s=30.0)
            self.auditor.close()
            if self.obs is not None:
                self.obs.set_gauge('audited_queries',
                                   self.auditor.audited)
        if self.qtracer is not None:
            self.qtracer.flush()
        if self.obs is not None:
            self.obs.flush()
            self._flush_capacity()
            self.obs.close()

    def _flush_capacity(self):
        """Persist the live capacity model as ``capacity.json`` so the
        recorded obs dir carries the utilization/saturation account, not
        just the live ``/status`` scrape."""
        if self.engine is not None and self.obs is not None:
            self.obs.write_artifact('capacity.json',
                                    self._capacity_status())


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='python -m dgmc_tpu_torch.serve',
        description='Online matching service: persistent query-serving '
                    'worker (ψ₁ corpus cache, one captured CUDA graph '
                    'per bucket, shortlist→consensus rerank) with '
                    '/match mounted beside the live telemetry plane. '
                    'Run under --supervise for warm self-healing '
                    'restarts.')
    add_serve_args(parser)
    args = parser.parse_args(argv)
    if args.supervise:
        # This process becomes the monitor before anything touches the
        # device: it never creates a CUDA context. No ladder: JAX's
        # only rung here, disable-fused, has no counterpart in the port.
        from dgmc_tpu_torch.resilience.supervisor import supervise_cli
        return supervise_cli('dgmc_tpu_torch.serve', args, argv, ladder=())
    if not args.obs_dir:
        raise SystemExit('serve: --obs-dir is required (the /match '
                         'plane and the latency account live there)')
    if args.obs_port is None:
        args.obs_port = 0
    service = ServeService(args).start()
    return service.serve_forever()
