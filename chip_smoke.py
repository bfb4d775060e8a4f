#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``dgmc_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

- ``build``: compiles every kernel of the serving path from
  ``dgmc_tpu_torch/csrc`` (one ``nvcc`` per source, started together).
- ``topk_kernel``: the CUDA top-k kernel against its plain PyTorch
  version on the card — bit-equal indices and values on integer-valued
  cases (ties, a random mask, k above the valid targets, tile
  boundaries, B=2, k at the kernel's limit), and on random float32
  inputs at the serve path's shapes (16, 32, 64 and 15000 x 20000,
  C=256, k=10) indices equal except inside a near-tie (see
  :func:`hold_near_ties`). Times the kernel, the plain version and
  ``torch.topk(h_s @ h_t^T)`` (yardstick only) at each of those shapes:
  median of CUDA-event timings after warm-up.
- ``serve``: the DBP15K-width model (seed-initialized) serving through
  ``MatchEngine`` over the 20000-node / 120000-edge synthetic corpus:
  8 sampled queries of 16-64 nodes and the whole 15000-node source KG as
  one query. Per query: the dispatch ledger shows the kernel, its launch
  count rose once, a repeat gives an identical answer. Then the kernel
  is held against its plain version on each query's own ψ₁ rows and the
  corpus table, and one small query answered on the CPU plain path must
  agree. A ``torch.profiler`` breakdown of a small and the whole-graph
  query follows (informational).

Output: the numbers, then the ``nvidia-smi`` name/power-limit line, then
one JSON line listing every kernel, and last
``{"ok": true, "device": {...}}``. Float32 is exact: TF32 is off for
matrix products and cuDNN.
"""

import concurrent.futures
import copy
import json
import os
import statistics
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (dense, no sparsity): float32 outside the
# tensor cores and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

TOPK_SHAPE = (1, 15000, 20000, 256, 10)   # B, N_s, N_t, C, k
SMALL_ROWS = (16, 32, 64)                  # the small buckets' N_s
BUCKETS = '16x48,32x96,64x192,15000x100000'
QUERY_NODES = (16, 23, 32, 41, 48, 57, 64, 16)


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, runs=10, warmup=2):
    """Median milliseconds of ``fn`` over ``runs`` CUDA-event timings."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_build():
    from dgmc_tpu_torch.ops.kernels import build
    sources = sorted(f for f in os.listdir(build.CSRC_DIR)
                     if f.endswith('.cu'))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(build.load_library, sources)))
    log(f'build: {len(libs)} kernel source(s) in '
        f'{time.perf_counter() - t0:.2f}s wall')
    for name, lib in libs.items():
        log(f'build: {name} nvcc {lib.build_seconds:.2f}s')
        for line in lib.build_log.splitlines():
            if 'registers' in line or 'spill' in line:
                log(f'build: {name} {line.strip()}')


def _topk_case(gen, B, N_s, N_t, C, k, mask_p=None, valid=None,
               ints=True):
    dev = torch.device('cuda')
    if ints:
        h_s = torch.randint(-2, 3, (B, N_s, C), generator=gen).float()
        h_t = torch.randint(-2, 3, (B, N_t, C), generator=gen).float()
    else:
        h_s = torch.randn(B, N_s, C, generator=gen)
        h_t = torch.randn(B, N_t, C, generator=gen)
    mask = None
    if mask_p is not None:
        mask = torch.rand(B, N_t, generator=gen) > mask_p
    if valid is not None:
        mask = (torch.arange(N_t) < valid).expand(B, N_t).clone()
    return (h_s.to(dev), h_t.to(dev), k,
            None if mask is None else mask.to(dev))


def hold_near_ties(label, h_s, h_t, k, mask=None):
    """Kernel against the plain version on continuous inputs → max |value
    error|. The two sum the channels in different orders, so:

    - indices: equal, except at a position p whose plain score lies
      within 1e-5 relative of a neighbour's in the plain top-(k+1)
      (p-1 or p+1; at p = k-1 that is the k-th against the (k+1)-th):
      a swap inside a near-tie;
    - values: within rtol 1e-5 and atol 1e-5 x the largest |score|.
    """
    from dgmc_tpu_torch.ops.kernels.topk import plain_topk, streaming_topk
    v, i = streaming_topk(h_s, h_t, k, mask)
    torch.cuda.synchronize()
    pv, pi = plain_topk(h_s, h_t, k + 1, mask)
    pv_k, pi_k = pv[..., :k], pi[..., :k]
    rel = (pv[..., :-1] - pv[..., 1:]).abs() / pv[..., 1:].abs().clamp(
        min=1e-30)
    tie_next = rel <= 1e-5                                  # p with p+1
    tie_prev = torch.cat([torch.zeros_like(tie_next[..., :1]),
                          tie_next[..., :-1]], dim=-1)      # p with p-1
    diff = i != pi_k
    bad_rows = diff.any(-1)
    unexplained = int((diff & ~(tie_next | tie_prev)).any(-1).sum())
    err = float((v - pv_k).abs().max())
    scale = float(pv_k.abs().max())
    log(f'topk_kernel: {label} {tuple(h_s.shape)}x{tuple(h_t.shape)} k={k}: '
        f'{int(bad_rows.sum())} rows differ, '
        f'{int(tie_next[..., k - 1].sum())} rows with k-th/(k+1)-th within '
        f'1e-5 rel; max |value err| {err:.3g}')
    if unexplained:
        raise AssertionError(f'{label}: {unexplained} rows differ outside '
                             f'a near-tie')
    if not torch.allclose(v, pv_k, rtol=1e-5, atol=1e-5 * scale):
        raise AssertionError(f'{label}: values differ by {err}')
    return err


def phase_topk_kernel(result):
    from dgmc_tpu_torch.ops.kernels.topk import (K_MAX, plain_topk,
                                                 streaming_topk)
    gen = torch.Generator().manual_seed(0)
    exact = {
        'ties_mask': _topk_case(gen, 2, 300, 700, 8, 7, mask_p=0.3),
        'k_above_valid': _topk_case(gen, 1, 40, 20, 4, 9, valid=5),
        'tile_64x64': _topk_case(gen, 1, 64, 64, 8, 3),
        'tile_65x65': _topk_case(gen, 1, 65, 65, 8, 3),
        'tile_128x128': _topk_case(gen, 1, 128, 128, 16, 5),
        'tile_129x129': _topk_case(gen, 1, 129, 129, 16, 5),
        'batch_2': _topk_case(gen, 2, 130, 1100, 16, 10, mask_p=0.5),
        'k_max': _topk_case(gen, 1, 200, 3000, 32, K_MAX, mask_p=0.9),
    }
    for name, (h_s, h_t, k, mask) in exact.items():
        v, i = streaming_topk(h_s, h_t, k, mask)
        torch.cuda.synchronize()
        pv, pi = plain_topk(h_s, h_t, k, mask)
        if not (torch.equal(i, pi) and torch.equal(v, pv)):
            raise AssertionError(
                f'topk case {name}: kernel differs from the plain version '
                f'in {int((i != pi).any(-1).sum())} rows')
        log(f'topk_kernel: case {name} {tuple(h_s.shape)}x'
            f'{tuple(h_t.shape)} k={k}: bit-equal')

    # The serve path's shapes: small queries (one row tile, the target
    # axis cut into segments and merged) and the whole source KG.
    B, N_s, N_t, C, k = TOPK_SHAPE
    err = 0.0
    for n in SMALL_ROWS:
        h_s, h_t, _, _ = _topk_case(gen, B, n, N_t, C, k, ints=False)
        err = max(err, hold_near_ties('random', h_s, h_t, k))
        ms = cuda_ms(lambda: streaming_topk(h_s, h_t, k))
        plain_ms = cuda_ms(lambda: plain_topk(h_s, h_t, k))
        lib_ms = cuda_ms(lambda: torch.topk(
            torch.bmm(h_s, h_t.transpose(1, 2)), k))
        log(f'topk_kernel: timing at {n}x{N_t} C={C} k={k} (median of 10): '
            f'kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, torch.topk(bmm) '
            f'{lib_ms:.3f} ms')
    h_s, h_t, _, _ = _topk_case(gen, B, N_s, N_t, C, k, ints=False)
    err = max(err, hold_near_ties('random', h_s, h_t, k))

    ms = cuda_ms(lambda: streaming_topk(h_s, h_t, k))
    plain_ms = cuda_ms(lambda: plain_topk(h_s, h_t, k))
    lib_ms = cuda_ms(lambda: torch.topk(
        torch.bmm(h_s, h_t.transpose(1, 2)), k))
    flops = 2.0 * B * N_s * N_t * C
    nbytes = 4.0 * B * (N_s + N_t) * C + B * N_t + 8.0 * B * N_s * k
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    bound_ms = 1e3 * max(t_ops, t_bytes)
    log(f'topk_kernel: timing at {N_s}x{N_t} C={C} k={k} (median of 10): '
        f'kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, torch.topk(bmm) '
        f'{lib_ms:.3f} ms, bound {bound_ms:.3f} ms '
        f'({flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB), kernel at '
        f'{flops / ms / 1e9:.2f} TFLOP/s')
    result.update({'name': 'topk', 'route': 'cuda',
                   'source': 'dgmc_tpu_torch/csrc/topk.cu',
                   'replaces': 'dgmc_tpu/ops/pallas/topk.py:40',
                   'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
                   'bound_ms': bound_ms,
                   'bound_by': 'operations' if t_ops >= t_bytes
                   else 'bytes',
                   'library_ms': lib_ms})


def profile_query(engine, graph, label, top=8):
    """Device time of one answered query by operator (torch.profiler):
    the breakdown behind the per-query latency. Informational: a
    profiler that records no device time prints 'not measured'."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    engine.match(graph)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        engine.match(graph)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []   # device-side events only: kernels, copies, memsets
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, 'self_device_time_total',
                         getattr(ev, 'self_cuda_time_total', 0))
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    busy_ms = sum(r[0] for r in rows) / 1e3
    if not rows:
        log(f'profile: {label}: device time not measured (the profiler '
            f'recorded none)')
        return
    rows.sort(reverse=True)
    log(f'profile: {label}: wall {wall_ms:.3f} ms under the profiler, '
        f'device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), '
        f'{sum(r[2] for r in rows)} device ops')
    for dev_us, key, count in rows[:top]:
        log(f'profile: {label}:   {dev_us / 1e3:9.3f} ms '
            f'{100 * dev_us / 1e3 / busy_ms:5.1f}%  x{count:<5d} {key[:70]}')


def phase_serve(result):
    from dgmc_tpu_torch.ops.graph import GraphBatch
    from dgmc_tpu_torch.ops.kernels import dispatch
    from dgmc_tpu_torch.serve.cli import dbp15k_kg, dbp15k_model
    from dgmc_tpu_torch.serve.client import sample_query
    from dgmc_tpu_torch.serve.corpus import Corpus, load_or_build
    from dgmc_tpu_torch.serve.engine import MatchEngine
    from dgmc_tpu_torch.serve.router import QueryRouter
    from dgmc_tpu_torch.utils.data import Graph

    t0 = time.perf_counter()
    kg = dbp15k_kg(seed=0)
    corpus = Corpus(kg.x_t, kg.senders_t, kg.receivers_t)
    model = dbp15k_model(seed=0)                    # stays on the CPU
    torch.cuda.reset_peak_memory_stats()
    index, info = load_or_build(None, copy.deepcopy(model.psi_1), corpus,
                                device='cuda')
    router = QueryRouter(BUCKETS, corpus.num_nodes, corpus.num_edges)
    engine = MatchEngine(copy.deepcopy(model), index, router, device='cuda')
    warm = engine.warm()
    log(f'serve: corpus {corpus.num_nodes} nodes / {corpus.num_edges} '
        f'edges / {corpus.feat_dim} features, index built in '
        f'{info["seconds"]}s, warm-up '
        + ', '.join(f'{s} {w["warm_s"]}s' for s, w in warm.items())
        + f', setup {time.perf_counter() - t0:.1f}s')

    queries = [sample_query(corpus.x, n, 3 * n, seed=100 + i)
               for i, n in enumerate(QUERY_NODES)]
    whole = Graph(edge_index=np.stack([kg.senders_s, kg.receivers_s]),
                  x=kg.x_s)
    queries.append((whole, kg.perm))

    # The main path: counters at 0 just before, read just after.
    dispatch.reset()
    answers, answered = [], 0
    for qi, (graph, gt) in enumerate(queries):
        before = dispatch.launch_counts()['topk']
        ans = engine.match(graph)
        answered += 1
        latency_ms = engine.last_latency_s * 1e3
        d = dispatch.decisions()['topk']
        launches = dispatch.launch_counts()['topk']
        if d['path'] != 'kernel' or launches != before + 1:
            raise AssertionError(f'query {qi}: topk {d} with launches '
                                 f'{before} -> {launches}')
        again = engine.match(graph)
        answered += 1
        if again != ans:
            raise AssertionError(f'query {qi}: a repeat gave another answer')
        hits1 = float(np.mean([m['target'] == int(t)
                               for m, t in zip(ans['matches'], gt)]))
        hits1_s0 = float(np.mean([m['initial'][0] == int(t)
                                  for m, t in zip(ans['matches'], gt)]))
        log(f'serve: query {qi} {graph.num_nodes} nodes / '
            f'{graph.num_edges} edges -> bucket {ans["bucket"]}: '
            f'{latency_ms:.3f} ms (repeat '
            f'{engine.last_latency_s * 1e3:.3f} ms, identical), hits@1 '
            f'{hits1:.4f} (S_0 {hits1_s0:.4f})')
        answers.append(ans)
    launches = dispatch.launch_counts()['topk']
    peak = torch.cuda.max_memory_allocated()
    if launches != answered:
        raise AssertionError(f'topk launched {launches} times for '
                             f'{answered} queries answered')
    log(f'serve: {answered} queries answered, topk kernel launches '
        f'{launches}; whole-graph hits@1 {hits1:.4f} (S_0 {hits1_s0:.4f}, '
        f'random weights); max_memory_allocated {peak} bytes '
        f'({peak / 2**30:.3f} GiB)')
    result['launches'] = launches

    # The kernel against its plain version on the inputs the main path
    # gave it: ψ₁ of each padded query against the corpus table.
    h_t = torch.as_tensor(index.h_t, dtype=torch.float32).cuda()
    t_mask = torch.ones(h_t.shape[:2], dtype=torch.bool, device='cuda')
    for qi, (graph, _) in enumerate(queries):
        bucket = router.route(graph.num_nodes, graph.num_edges)
        q = GraphBatch.from_numpy(router.pad_query(graph, bucket), 'cuda')
        with torch.inference_mode():
            h_s = engine.model.psi_1(q.x, q)
        result['max_abs_err'] = max(result['max_abs_err'], hold_near_ties(
            f'serve query {qi}', h_s, h_t, engine.model.k, t_mask))

    for qi in (0, len(queries) - 1):
        try:
            profile_query(engine, queries[qi][0], f'query {qi}')
        except Exception as e:   # the breakdown is informational only
            log(f'profile: query {qi}: not measured ({e!r})')

    # One small query on the CPU plain path, same weights and table.
    small = [b for b in router.buckets if b.nodes <= 64]
    cpu = MatchEngine(model, index, QueryRouter(
        small, corpus.num_nodes, corpus.num_edges), device='cpu')
    cpu.warm()
    want = cpu.match(queries[0][0])
    got = answers[0]
    if want['shortlist'] != got['shortlist']:
        raise AssertionError('CPU and CUDA shortlists differ')
    err = 0.0
    for mg, mw in zip(got['matches'], want['matches']):
        if [c[0] for c in mg['candidates']] != [c[0] for c in
                                                mw['candidates']]:
            raise AssertionError(f'node {mg["node"]}: CPU and CUDA '
                                 f'candidates differ')
        err = max(err, max(abs(a[1] - b[1]) for a, b in
                           zip(mg['candidates'], mw['candidates'])))
    if err > 1e-4:
        raise AssertionError(f'CPU and CUDA probabilities differ by {err}')
    log(f'serve: CPU plain path agrees on query 0 (shortlist and '
        f'candidates equal, max |prob diff| {err:.3g})')


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing was run', file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import dgmc_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f'chip_smoke: the dgmc_tpu_torch package is not beside this '
              f'script ({e})', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    log(f'chip_smoke: torch {torch.__version__} CUDA {torch.version.cuda} '
        f'on {torch.cuda.get_device_name(0)}; TF32 off')

    topk = {}
    failed = []
    for name, fn in (('build', phase_build),
                     ('topk_kernel', lambda: phase_topk_kernel(topk)),
                     ('serve', lambda: phase_serve(topk))):
        t0 = time.perf_counter()
        try:
            fn()
            log(f'phase {name}: ok in {time.perf_counter() - t0:.1f}s')
        except Exception:
            traceback.print_exc()
            failed.append(name)
            log(f'phase {name}: FAILED')
            if name == 'build':
                break
    if failed:
        print(f'chip_smoke: failed phases: {failed}', file=sys.stderr)
        return 1
    log(smi[0] if smi else 'nvidia-smi: no output')
    keys = ('name', 'route', 'source', 'replaces', 'launches',
            'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
            'library_ms')
    print(json.dumps({'kernels': [{k: topk[k] for k in keys}]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
