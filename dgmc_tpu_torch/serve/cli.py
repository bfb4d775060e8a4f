"""``python -m dgmc_tpu_torch.serve.cli``: answer sampled queries at DBP15K
width and exit (the serving worker is ``python -m dgmc_tpu_torch.serve``,
:mod:`~dgmc_tpu_torch.serve.service`).

Seed-initializes the DBP15K-configuration DGMC (ψ₁ = ``RelCNN(300, 256,
3)``, ψ₂ = ``RelCNN(32, 32, 3)``, ``k=10``, ``num_steps=10``), builds the
corpus index over the target KG of the synthetic DBP15K alignment
(20000 nodes, 120000 edges, 300 features), warms the declared buckets,
then answers ``--num-queries`` sampled queries and prints each answer as
one JSON line on standard output. Progress goes to standard error.
``--stream-chunk`` and ``--offload-corpus`` (with ``--offload-chunk`` and
``--prefetch-depth``) select the streamed and the host-RAM corpus tiers
(:mod:`~dgmc_tpu_torch.serve.engine`).

``--ckpt_dir DIR`` serves trained weights: the newest good step under
``DIR`` (:mod:`~dgmc_tpu_torch.train.checkpoint`, as the DBP15K CLI's
``--ckpt_dir`` writes it) is restored into the model, parameters and
buffers, with a strict state dict, and the corpus cache defaults to
``DIR/corpus_cache``, its meta recording the step. An empty ``DIR``
exits with a notice unless ``--init-missing`` saves the seeded model as
step 0 first. Without ``--ckpt_dir`` the weights are seeded.
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from dgmc_tpu_torch import resolve_device, set_exact_float32
from dgmc_tpu_torch.data.synthetic import synthetic_kg_alignment
from dgmc_tpu_torch.models.dgmc import DGMC
from dgmc_tpu_torch.models.rel import RelCNN
from dgmc_tpu_torch.serve.client import sample_query
from dgmc_tpu_torch.serve.corpus import Corpus, load_or_build
from dgmc_tpu_torch.serve.engine import MatchEngine
from dgmc_tpu_torch.serve.router import QueryRouter
from dgmc_tpu_torch.train.checkpoint import Checkpointer
from dgmc_tpu_torch.train.state import create_train_state

__all__ = ['DBP15K', 'dbp15k_model', 'dbp15k_kg', 'restore', 'main']

#: The DBP15K configuration (``dgmc_tpu/experiments/dbp15k.py``: model
#: widths and the synthetic KG's CLI defaults).
DBP15K = {'feat_dim': 300, 'dim': 256, 'rnd_dim': 32, 'num_layers': 3,
          'num_steps': 10, 'k': 10, 'nodes_s': 15000, 'nodes_t': 20000,
          'edges_s': 100000, 'edges_t': 120000}


def dbp15k_model(seed=0, num_layers=DBP15K['num_layers']):
    """The DBP15K-width DGMC with flax-default weights drawn from a
    ``torch.Generator`` seeded with ``seed`` (built on the CPU)."""
    c = DBP15K
    psi_1 = RelCNN(c['feat_dim'], c['dim'], num_layers, batch_norm=False,
                   cat=True, lin=True, dropout=0.0)
    psi_2 = RelCNN(c['rnd_dim'], c['rnd_dim'], num_layers, batch_norm=False,
                   cat=True, lin=True, dropout=0.0)
    g = torch.Generator().manual_seed(int(seed))
    return DGMC(psi_1, psi_2, num_steps=c['num_steps'], k=c['k'],
                generator=g).eval()


def dbp15k_kg(seed=0):
    """The synthetic DBP15K-shaped alignment at its CLI defaults."""
    c = DBP15K
    return synthetic_kg_alignment(c['nodes_s'], c['nodes_t'], c['edges_s'],
                                  c['edges_t'], c['feat_dim'],
                                  rng=np.random.RandomState(seed))


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog='python -m dgmc_tpu_torch.serve.cli',
                                description=__doc__.split('\n\n')[0])
    p.add_argument('--num-queries', type=int, default=8)
    p.add_argument('--buckets', default='16x48,32x96,64x192')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--max-results', type=int, default=5)
    p.add_argument('--ckpt_dir', '--ckpt-dir', dest='ckpt_dir', default=None,
                   help='serve the newest good checkpoint under this '
                        'directory (train/checkpoint.py layout; default: '
                        'seeded weights)')
    p.add_argument('--init-missing', '--init_missing', dest='init_missing',
                   action='store_true',
                   help='if --ckpt_dir holds no checkpoint, save the seeded '
                        'model there as step 0 before serving')
    p.add_argument('--cache-dir', default=None,
                   help='corpus-table cache directory (default: '
                        '<ckpt_dir>/corpus_cache with --ckpt_dir, else '
                        'none)')
    p.add_argument('--stream-chunk', '--stream_chunk', dest='stream_chunk',
                   type=int, default=0,
                   help='streamed tier: the shortlist search over source '
                        'chunks of this many rows (0 = off)')
    p.add_argument('--offload-corpus', '--offload_corpus',
                   dest='offload_corpus', action='store_true',
                   help='host-RAM corpus tier: the ψ₁ table stays in host '
                        'memory; the shortlist streams target chunks '
                        'through the prefetch ring and the rerank graph '
                        'takes the shortlist and its candidate rows')
    p.add_argument('--offload-chunk', '--offload_chunk', dest='offload_chunk',
                   type=int, default=4096)
    p.add_argument('--prefetch-depth', '--prefetch_depth',
                   dest='prefetch_depth', type=int, default=0,
                   help='prefetch ring depth for --offload-corpus (0 = '
                        'ops/offload.DEFAULT_PREFETCH_DEPTH)')
    p.add_argument('--device', default=None,
                   help="torch device (default cuda; 'cpu' runs the plain "
                        'PyTorch path)')
    return p.parse_args(argv)


def restore(model, ckpt_dir, init_missing=False):
    """Restore ``model`` in place from the newest good step under
    ``ckpt_dir`` (parameters and buffers, strict); returns the step. An
    empty directory raises ``SystemExit`` unless ``init_missing``, which
    saves ``model`` as it is (with a fresh optimizer) as step 0 first."""
    ckpt = Checkpointer(ckpt_dir)
    if not ckpt.all_steps():
        if not init_missing:
            raise SystemExit(f'serve: no checkpoint under {ckpt_dir} (pass '
                             f'--init-missing to save the seeded weights as '
                             f'step 0)')
        ckpt.save(0, model, create_train_state(model))
    ckpt.restore(model)
    return ckpt.restored_step


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    set_exact_float32()

    def log(msg):
        print(f'serve: {msg}', file=sys.stderr, flush=True)

    kg = dbp15k_kg(args.seed)
    corpus = Corpus(kg.x_t, kg.senders_t, kg.receivers_t)
    model = dbp15k_model(args.seed).to(device)
    model.stream_chunk = args.stream_chunk or None
    step, cache_dir = None, args.cache_dir
    if args.ckpt_dir:
        step = restore(model, args.ckpt_dir, args.init_missing)
        log(f'restored checkpoint step {step} from {args.ckpt_dir}')
        if cache_dir is None:
            cache_dir = os.path.join(args.ckpt_dir, 'corpus_cache')
    index, info = load_or_build(cache_dir, model.psi_1, corpus,
                                device=device, log=log,
                                checkpoint_step=step)
    router = QueryRouter(args.buckets, corpus.num_nodes, corpus.num_edges)
    engine = MatchEngine(model, index, router,
                         max_results=args.max_results, device=device,
                         offload=args.offload_corpus,
                         offload_chunk=args.offload_chunk,
                         prefetch_depth=args.prefetch_depth or None)
    t0 = time.perf_counter()
    report = engine.warm()
    log(f'{engine.buckets_warm} buckets warm in '
        f'{time.perf_counter() - t0:.2f}s (cache {info["cache"]}) on '
        f'{device}')
    for sig, r in report.items():
        log(f'bucket {sig}: captured in {r["capture_s"]}s, static memory '
            f'{r["memory"]["total_bytes"] >> 20} MiB (temps '
            f'{r["memory"]["temp_bytes"] >> 20} MiB)')
    largest = max(b.nodes for b in router.buckets)
    rng = np.random.RandomState(args.seed)
    for i in range(args.num_queries):
        n = int(rng.randint(min(16, largest), min(64, largest) + 1))
        graph, gt = sample_query(corpus.x, n, 3 * n,
                                 seed=args.seed + 1 + i)
        answer = engine.match(graph)
        answer['shortlist'] = answer.pop('_audit')['shortlist_idx']
        answer['query'] = i
        answer['latency_ms'] = round(engine.last_latency_s * 1e3, 3)
        answer['hits1'] = float(np.mean(
            [m['target'] == g for m, g in zip(answer['matches'], gt)]))
        print(json.dumps(answer), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
