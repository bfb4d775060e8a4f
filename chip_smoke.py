#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``dgmc_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 chip_smoke.py
    python3 chip_smoke.py --steps N [--root DIR]
    python3 chip_smoke.py --kernels [--root DIR]

With ``--steps`` it runs none of the phases below: it builds the kernels
of the ``dgmc_tpu_torch`` under ``DIR`` (default: beside this script),
then, under each precision policy, times N synchronized steps (after 2
warm-up steps) of the dense PascalPF training loop (the CLI's defaults:
a new batch each step, collated in the step's thread; a tree with pinned
host batches and ``PrefetchLoader`` also runs it with the batches made
in the loader's thread, as its CLI does since the steps are captured)
and of the KG phase-2 step (on a
tree with captured steps, the CLIs' default, also the eager loops of
both, ``jit=False``), splits each step's time into the draws, the wait
for the batch, the upload, the replay call, the wait for the device and
the rest (:func:`steps`), profiles one more of each and prints one JSON
line of medians with min and max, the split, device busy time and
share, device ops, the port's kernels by name, the dtype each ran in and
each captured graph's static memory; on a tree with batch norm also the
captured KG phase-2 step of the ``backbones`` phase (``kg_phase2_bn``:
ψ₂ once per step on each side). It takes any tree of the port with the precision policy. With
``--kernels`` it builds them and times, at the main path's shapes, the
two sparse consensus kernels, a whole SplineCNN call's routing and
``route_fwd``, and the top-k kernel at a query's rows beside
``torch.topk(bmm)`` (:func:`kernel_times`).
Running either for two trees in turns in one call (say, an unpacked
parent commit, then this one) compares them on one card.

Phases (any failure exits non-zero and prints no result line). The
float32 phases pin ``--precision f32`` (the CLIs default to bf16); the
``*_bf16`` phases run the bf16 policy:

- ``build``: starts compiling every kernel source of
  ``dgmc_tpu_torch/csrc`` (one ``nvcc`` per source, all side by side)
  and builds the C++ collation (``dgmc_tpu_torch/native``, ``g++``).
  Each later phase waits for the sources it needs (:func:`await_builds`):
  the kernel phases run in the order their sources finish (spline,
  consensus, rng, blocked, topk, sparse consensus; the phases below are
  listed by kernel, not in that order), while the slower sources still
  compile.
- ``topk_kernel``: the CUDA top-k kernel against its plain PyTorch
  version on the card — bit-equal indices and values on integer-valued
  cases (ties, a random mask, k above the valid targets, tile
  boundaries, B=2, k at the kernel's limit, and 16, 17 and 33 rows
  against 20000 targets: each small row tile through the segment merge,
  once with k at the limit), and on random float32
  inputs at the serve path's shapes (16, 32, 64 and 15000 x 20000,
  C=256, k=10) indices equal except inside a near-tie (see
  :func:`hold_near_ties`). Times the kernel, the plain version and
  ``torch.topk(h_s @ h_t^T)`` (yardstick only) at each of those shapes:
  the small ones by device time (every launch of a call summed) beside
  the CUDA-event time, the whole KG by CUDA events (median of 10 after
  warm-up), each with its bound.
- ``spline_kernel``: the SplineConv routing kernels (forward and the
  gradient w.r.t. t) against their plain versions — bit-equal on exact
  inputs (an all-masked batch, M not a multiple of any tile, B=1, no
  edges, the training width, a hub row that 30% of the slots point at
  beside empty rows, for d_t at O=64 and O=256, and a hub receiver that
  30% of the edges go to beside rows without an edge, for the forward at
  O=3, 64 and 256), within rtol 1e-5 / atol 1e-5 x max|out| on float32
  inputs and on the four SplineConv shapes of the training path over a
  real ``RandomGraphPairs`` batch; repeats bit-identical; the forward's
  edge records and the d_t kernel's slot records, built by one launch of
  a kernel of their own, bit-equal to their plain versions. Times the
  kernels, the plain versions and ``torch.sparse.mm`` of the
  block-diagonal routing matrix (yardstick only) at O=256 and O=64, each
  with its bound, and the records' build (once per routing, outside the
  routes' times, on a row of its own).
- ``consensus_kernel``: the dense consensus kernels (the shared
  projection, then the pair kernel) against their plain factored version,
  the same way, at [64, 80, 80], R=64, ragged cases and R=33 and R=128;
  times them (and each launch) and the plain version (no single PyTorch
  call computes it), and the plain tile-recompute backward at the same
  shape (device time per call and by op).
- ``sparse_consensus_kernel``: the sparse consensus kernels (forward and
  backward) against their plain versions — bit-equal on exact inputs (a
  duplicate-heavy shortlist, one row, K=1, R=128, B=2, a Zipf hub
  shortlist at the DBP15K shape, K=40 at R=33; then a duplicate-heavy
  shortlist, R=128, a Zipf hub and K=40 over more target rows than
  candidates, so that the forward forms u_t of the touched rows only),
  its ReLU mask equal to the plain ``pre > 0``; the backward from the
  forward's state, as the main path hands it over, also against
  autograd of the unfused plain form, while the plain version forms u
  itself; the narrow form under the identity shortlist against
  autograd), within rtol 1e-5 / atol 1e-5 x max|out| on float32 at [1,
  15000, 20, 32] and [1, 15000, 10, 32] over 20000 targets and at the
  serve query shapes (16, 32, 64 rows, K=10, touched rows only);
  repeats bit-identical. Times both kernels
  (the forward with and without writing the state; the JSON line carries
  the forward as training calls it, writing the state, at K=20, and at
  each serve shape), each launch, and their plain versions (no single
  PyTorch call computes them). Also shows that the port's gather
  gradient repeats bit-identically.
- ``bf16_kernels``: each kernel's bf16 variant (the precision policy's)
  against its plain bf16 version on the card: bit-equal on exact inputs
  (small integers and quarters, exact in bf16; the sparse consensus
  forward's ReLU mask too); on continuous inputs at the main path's
  shapes (top-k at 15000 x 20000 x 256, the SplineConv routing at O=256
  and O=64 on a real batch, the dense consensus at [64, 80, 80], R=64,
  the sparse consensus at [1, 15000, 20, 32] over 20000 targets) a bf16
  output within one bf16 ulp (:func:`hold_ulp`), a float32 one within
  rtol 1e-5 / atol 1e-5 x max|out|, top-k's picks by
  :func:`hold_bf16_topk` (a swap only inside a near-tie of the plain bf16
  scores; values equal where the indices agree, an ulp where they
  differ). Top-k's exact cases each assert the route the dispatch
  ledger records: the tensor-core tile (``tensor-core``; its edges: rows
  and targets no multiple of a tile, C = 200 and 264, k = 1 and 16,
  whole masked blocks, k above the valid targets, B = 2, C = 256 and the
  main shape) or the FMA kernel with its reason (C % 8 != 0, k > 16,
  C > 640). Times each beside its float32 variant on the same
  values, its plain version and the PyTorch call in bf16 where there is
  one, each with its bound in bf16 bytes and operations at the bf16
  peak; top-k in one row, the same values: the tensor-core kernel, the
  bf16 FMA entry, the float32 kernel, ``torch.topk(bmm)`` in bf16 and
  the plain version, with the share of the bound reached.
- ``blocked_kernel``: the blocked aggregation kernel
  (``csrc/blocked.cu``; no Pallas counterpart: JAX's one-hot einsums of
  ``dgmc_tpu/ops/blocked.py``) against its plain version
  (:func:`phase_blocked_kernel`): bit-identical to
  ``ordered_aggregate`` (torch over the row table, the kernel's order and
  rounding) on every case, and bit-equal to the plain version on
  integer-valued rows (a hub range beside padded blocks, an edgeless
  graph), within rtol 1e-5 / atol 1e-5 x max|out| of it on the synthetic
  KGs' tables at C = 1, 32 (the per-step ψ₂), 40, 256 (ψ₁) and 320 (the
  packed ψ₂), both directions, forward and backward, float32 and bf16
  rows; repeats bit-identical. Times the kernel, the plain version,
  ``torch.sparse.mm`` (yardstick only) and the gather + segment path it
  replaces, each with its bound, and the hub case.
- ``rng_kernel``: the draw kernel (``csrc/rng.cu``, Philox4x32-10)
  against its plain version on the CPU, the device the stream must not
  depend on (:func:`phase_rng_kernel`): normals at the dense noise's
  [10, 64, 80, 64], the KG and whole-graph query noise's [10, 1, 15000,
  32] and the small queries' shapes within one float32 ulp (the count of
  elements that differ at all printed), uniforms (negatives over 2^24
  targets: the words' 24 bits) and negatives [1, 15000, 10] over 20000
  targets bit-equal; repeats bit-identical; a batch of pairs equal to
  each pair drawn alone at its offset. Times the kernel, its plain
  version on the card and ``torch.randn`` / ``torch.randint`` (yardstick
  only), each with its bound (the bytes written).
- ``serve``: the DBP15K-width model (seed-initialized) serving through
  ``MatchEngine`` over the 20000-node / 120000-edge synthetic corpus:
  8 sampled queries of 16-64 nodes and the whole 15000-node source KG as
  one query. Per query: the dispatch ledger shows the kernels, the top-k
  launch count rose once, the sparse-consensus forward's once per
  consensus step (10) and the draw's once (the query's noise), a repeat
  gives an identical answer; the counts are filed by the query's padded
  rows; every collation took the native path. Then the kernel
  is held against its plain version on each query's own ψ₁ rows and the
  corpus table, and one small query answered on the CPU plain path must
  agree. Then the streamed (``stream_chunk`` 4096) and the offload tier
  (host table, 4096-row target chunks through the ring, the rerank graph
  fed the shortlist): every answer bit-identical to the device tier's,
  top-k launches one a chunk. A ``torch.profiler`` breakdown of a small
  and the whole-graph
  query follows (informational).
- ``train``: the PascalPF-width dense model trained through the CLI's
  own ``main`` (one epoch of 16 steps of 64 pairs, 80 nodes / 640 edges,
  plus 128 held-out pairs): the dispatch ledger shows the kernels, the
  launch counters (route fwd / d_t / dense consensus / records / draw)
  rise by 44/44/10/2/1 per train step and 44/0/10/2/1 per eval batch
  (the records once per graph batch: the routing is cached on it), every
  loss is finite, every collation took the native path; the spline
  launches are also filed by the width they ran at
  (:func:`spline_launches_by_width`). Then: the losses and gradients of
  the CLI's first four steps (its batches, each device drawing the
  step's noise itself) against the CPU plain path on the same weights
  (:func:`_hold_grads`: ``GRAD_TOL``, with a float64 CPU reference
  beyond it, over the four draws; the card's path without the port's
  kernels printed beside); two 2-step
  runs from one seed give bit-identical losses; the median step time,
  pairs/s, peak memory and a profile of one step (informational).
- ``kg_train``: sparse DGMC trained at the DBP15K width and shapes on the
  synthetic KG alignment (15000 / 20000 entities, 100000 / 120000 edges)
  through the CLI's own ``dbp15k.main``: 10 phase-1 epochs (one eval),
  then 4 phase-2 epochs with their evals. The dispatch ledger shows the
  kernels; the launch counters (topk / sparse-consensus forward /
  backward / draw) rise by 1/0/0/1 per phase-1 step, 1/0/0/0 per phase-1
  eval, 1/10/10/2 per phase-2 step and 1/10/0/1 per phase-2 eval (the
  blocked aggregation, the CLI's default ``--blocked_adjacency auto``, 24
  / 12 / 144 / 78, filed by width and rows dtype); every
  loss is finite; the collation took the native path. Then: the losses
  and gradients of a phase-2 step under the draws of the CLI's first six
  phase-2 steps against the CPU plain path on the same weights and
  shortlist, each device drawing the noise and negatives itself, ψ₁'s
  dropout off, at the full widths and 1500 / 2000 entities (as in
  ``train``); two 2-step phase-2 runs from one seed give
  bit-identical losses; median step times, peak memory and a profile of
  one phase-2 step (informational), with each of the port's kernels'
  device time per launch on the real phase-2 shortlists.

- ``train_bf16`` and ``kg_train_bf16``: the two training main paths
  again under the bf16 policy at the same widths and depths: the launch
  counters per step as above, the dispatch ledger showing every kernel
  in bfloat16 (the spline records keep float32 basis weights) and all
  19 top-k launches on the tensor-core route, every
  loss finite and falling (the dense epoch's last four steps below its
  first four; KG phase 1's tenth loss below its first); the top-k
  kernel held by :func:`hold_bf16_topk` on the trained KG model's own
  ψ₁ outputs; then one step of
  each profiled with its peak memory, as ``train`` and ``kg_train`` do
  for float32 (informational).

- ``kg_tiers``: the KG path's other memory tiers through
  ``dbp15k.main`` at full width (:func:`phase_kg_tiers`):
  ``--blocked_adjacency off`` (4 epochs, its phase-1 losses within 1e-4
  of ``kg_train``'s), ``--stream_chunk 4096 --offload-corpus`` (2
  epochs, 4 top-k launches a step, ``equal=True``), and
  ``python -m dgmc_tpu_torch.ops.offload`` at its default sizes.
- ``union_route``: the routed candidate sums and the pair union on the
  DBP15K model at the JAX CLI's widths (:func:`phase_union_route`): (a)
  the blocked kernel's routed entry (``csrc/blocked.cu``,
  ``dgmc_blocked_route``; ``ops/corr_route.py``) at the phase-2 training
  shape ([1, 15000, 20] over 20000 targets, the model's own shortlist):
  the scaled projection and the gather's backward at C = 32,
  bit-identical to the scaled ``ordered_aggregate``, within rtol / atol
  1e-5 of JAX's one-hot plain version, exact small cases bit-equal;
  times beside the bound, the plain version and ``torch.sparse.mm``; the
  largest target in-degree; (b) the captured phase-2 step with
  ``route_sparse=True`` under both policies, bit-identical to eager,
  launches per step, loss and gradients against the default path, the
  median of 20 steps beside the default's; (c) ``batch_pair`` in
  {'psi_1', 'psi_2', True}: the forward against the two-call model (rtol
  5e-4, atol 5e-5), a captured training step each; (d) the refusals on
  CUDA tensors.
- ``capture``: the captured steps (``jit=True``, the CLIs' default: one
  CUDA graph per step function and input signature, every capture under
  ``torch.cuda.set_sync_debug_mode('error')``) against the eager ones
  (``jit=False``) on the card, from one initial state, under both
  policies: the dense train step over the CLI's first 5 batches and
  seeds and the eval step over 2 held-out batches; the KG phase-1,
  eval1, phase-2 and eval2 steps, 5 each at the CLI's seeds (ψ₁'s
  dropout masks included). Every loss and metric, then every parameter
  and Adam tensor, bit-identical; the launches per replay equal to the
  eager step's (and to the main paths' counts above); each graph's
  capture seconds and static memory printed. Then one short
  ``dbp15k.main --aot_compile`` (12 epochs, 10 of phase 1): its four
  ``aot_memory_*`` events and losses bit-identical to ``kg_train``'s
  first 12. (The ``serve`` phase holds each bucket's replayed answer,
  with the engine's noise and with a query's own, bit-identical to the
  eager query path on the card.)
- ``backbones``: the backbones without a CLI of their own, each eager
  (``jit=False``) against captured from one state, outputs, parameters,
  Adam state and batch-norm buffers bit-identical, the launch counters
  at 0 just before each part and every kernel of the part launched:
  (a) the KG path with batch norm in ψ₁ and ψ₂ (:func:`bn_kg_model`, the
  DBP15K widths and sizes), 3 phase-1 steps, 3 phase-2 steps and a
  phase-2 eval under each policy, launches as ``kg_train``'s, ψ₂ called
  20 times a phase-2 call (per step on each side) where the CLI's packed
  model makes 11; (b) dense DGMC with GIN ψ₁ (1 → 256, batch norm,
  ``cat=False``) and ψ₂ (64 → 64, batch norm) on PascalPF's batches,
  2 train steps and an eval batch under each policy, 10
  ``consensus_update`` launches a call; (c) sparse DGMC (k = 10) with the
  dense CLI's SplineCNN ψ₁ and ψ₂, one training step (top-k, sparse
  consensus, ``route_aggregate`` forward and ``d_t``); (d)
  ``MatchEngine`` over (a)'s trained float32 model, buckets
  ``16x48,64x192``: three queries, each captured answer bit-identical to
  the eager engine's. Each part's kernels are held against their plain
  versions on the card on the inputs the path gave them
  (:func:`hold_path_kernels`).
- ``resume``: checkpoints, the guard and resume at the DBP15K width
  (float32, captured; :func:`phase_resume`): (a) an uninterrupted
  6-epoch run (3 of phase 1) with ``--ckpt_dir``, launches as
  ``kg_train``'s, its saves asynchronous (the blocking seconds printed);
  (b) the same run with a save every epoch, killed by ``sigkill@5`` with
  step 4's write in flight after ``ckpt-corrupt@3``, then resumed in a
  second process from step 2, the last committed good step: its step-6
  checkpoint (every model tensor and Adam tensor) and last eval line
  bit-identical to (a)'s; (c) ``--guard-bad-steps 1
  --inject-fault nan-grads@5``: the bad step skipped in the graph, the
  rollback to (a)'s step-4 parameters bit for bit, the guarded step eager
  against captured bit for bit, an asynchronous save followed at once by
  a replay that writes the state in place restoring the state at the
  save bit for bit, the device ops of an unguarded replay,
  one with the guard alone and one with the fault armed too; then
  ``--guard-bad-steps 3`` with no fault, resumed from (a)'s step 2
  through both phases: its steps 4 and 6 bit-identical to (a)'s; (d) the
  serve CLI over (a)'s checkpoint twice (cache
  miss, then hit, the same answers) and ``--init-missing`` answering as
  the seeded CLI. Each save's seconds and bytes, the restore's seconds
  and the seconds to the first step after it, beside the card's name and
  power limit.
- ``keypoints``: the PascalVOC and WILLOW experiments on a fixture tree
  written in a temporary directory (:func:`phase_keypoints`): (a) the
  dense consensus at [512, N, N], R = 128, and the routing kernels at
  O = 256 and 128, D = 2 and 1, float32 and bf16, on the ``pascal``
  loader's own batches, held and timed as the kernel phases hold and
  time theirs; (b) the VGG16 extractor on the card against the CPU; (c)
  ``pascal.main`` at the JAX CLI's widths under both policies, (d)
  ``--isotropic``, (e) ``willow.main`` (run 2's first replayed step
  bit-identical to an eager one from the snapshot), (f) ``pascal_pf.main
  --data_root``, each with the launches of the formula a step and eval
  batch.
- ``obs``: the run plane (``dgmc_tpu_torch/obs``, :func:`phase_obs`):
  (a) ``dbp15k.main`` at full width, bf16, 13 epochs (10 of phase 1)
  with ``--obs-dir --obs-port 0 --probes --watchdog-deadline --slo``,
  the launch counters at 0 before it and at ``KG_PER``'s counts: after
  every step ``/healthz``, ``/metrics`` and ``/status`` answer 200 and
  count the steps; every artifact with JAX's top-level keys
  (:data:`OBS_KEYS`); each phase-2 step's probe series complete; one
  capture per step function; (b) the captured KG phase-2 and PascalPF
  steps under each policy: an observer with probes off changes no
  output bit and no launch, the captured step's probe tape equals the
  eager step's bit for bit; (c) ``pascal_pf.main --profile-dir
  --profile-steps 1:3``: the trace names the steps and the port's
  kernels; (d) the run in (a) with ``--guard-bad-steps 1 --inject-fault
  nan-grads@12`` names ``grad`` at step 11 as the first offender and
  dumps ``flight.json`` at the rollback, and a device-side stall
  (``torch.cuda._sleep``) turns ``/healthz`` 503 and writes
  ``hang_report.json`` with the main thread in the synchronize; (e) the
  observer's cost on the captured bf16 KG phase-2 step: no observer,
  probes off, probes on (30 synchronized steps each in turns, then 30
  back to back, and one profiled replay's device ops and busy time); (f)
  the run-comparison readers: ``aggregate`` over (a)'s dir (one host, one
  device, a step-time ratio of 1.0), ``diff`` of (a) against itself
  (every gated key and launched kernel ``ok``, the poisoned step its one
  regression, rc 1), ``calibrate`` over three tiny observed
  ``pascal_pf.main`` runs (the JAX CI's flags) and their calibrated
  ``diff`` (rc 0), the same run with ``--device cpu`` against the card's
  (a ``dispatch[...]`` regression per dense kernel, memory and idle
  skipped), each reader's seconds printed.
- ``serve_worker``: the serving worker under the supervisor
  (:func:`phase_serve_worker`; ``python -m dgmc_tpu_torch.serve
  --supervise`` at DBP15K's widths, float32, buckets
  ``16x48,32x96,64x192``, the synthetic alignment's target KG as the
  corpus): (a) nine queries through HTTP bit-identical to the in-process
  engine, repeated and from 4 concurrent clients, every error class,
  ``/metrics`` strict-parsed, ``/status``'s ``qtrace`` and ``capacity``,
  the worker's ``dispatch.json`` (top-k and the sparse consensus forward
  launched, per query), the shadow audit on the card (recall 1.0), and
  latency over 100 queries a bucket beside the in-process engine's;
  (b) SIGKILL: restarted, a corpus-cache hit, the same answers; (c)
  SIGSTOP: killed as stale, restarted; (d) SIGTERM: a clean exit, the
  artifacts on disk, no CUDA context in the monitor; (e) ``dbp15k
  --supervise`` with ``sigkill@5`` bit-identical to the ``resume``
  phase's uninterrupted run; (f) ``diff`` of the worker's dir against
  itself with the serve gates armed (rc 0) and of (e) against its
  completed attempt read alone (rc 1: ``restarts``).
- ``lint``: the port's static analysis (``dgmc_tpu_torch/analysis``,
  :func:`phase_lint`): (a) ``python -m dgmc_tpu_torch.analysis.lint
  --json --fail-on new`` over this checkout, ``_build/`` skipped: rc 0
  against ``lint-baseline-torch.json``; (b) the recompile pass over the
  ``obs`` KG dir and the worker's attempt dirs: buckets, compile events
  by kind (captures, ``nvcc`` builds, the build phase's cold count
  beside), no RCP202; (c) a captured ``.item()`` raises on the card at
  the line the SRC tier flags (SRC102); (d) the trace tier over the
  eight specimens on the card in this process, rc 0 against the
  baseline, no TRC003 or TRC004, each specimen's kernel launches, and a
  ``.item()`` and an ``index_add_`` step flagged at their lines (TRC003,
  TRC005); (e) the specimen cost rows into an obs dir (each
  ``static_peak_bytes`` beside the allocator's measured peak) and
  ``obs.diff --max-peak-regression`` over them; (f) the five mesh
  specimens on 4 gloo ranks sharing the card (started at the start of
  ``obs``, joined here; (d)'s CLI run reads them: its trace, SHD and
  SCH/MEM tiers, rc 0 against the baseline): each rank's kernel launches
  from its ledger (:data:`MESH_KERNELS`), each specimen's collective
  table, ``overlap_fraction``, ``critical_path_share`` and static peak,
  and a variant of ``sharded_forward_rows`` that all-gathers the whole S
  tripping SHD302.

- ``parallel``: the port's multi-process paths
  (``dgmc_tpu_torch/parallel``, :func:`phase_parallel`): (a) one rank on
  NCCL, brought up by ``initialize_distributed`` with explicit
  arguments: the row-sharded KG phase-2 step at full width, captured with
  its all-reduces inside the graph, bit-identical (loss and parameters,
  3 steps) to the unsharded captured step with the same launches; (b)
  two ranks sharing the card (gloo, CUDA tensors staged through the
  host: NCCL refuses two ranks on one device): ``sharded_topk_rows`` and
  the ring (the target shards in JAX's rotation order, each from the
  rank's own copy) at 15000 x 20000 x 256, k = 10, float32 and bf16,
  each rank's indices gathered equal to the one-process kernel's, each
  rank's ``topk.cu`` launches and ms; (c) ``python -m
  dgmc_tpu_torch.experiments.dbp15k --synthetic --row_shards 2
  --num_processes 2`` at full width into phase 2 (float32, 3 epochs):
  its epoch lines within loss rel 1e-4 and Hits@1 / Hits@10 within
  2e-3 of the one-process run's, each rank's launches of the top-k, the
  sparse consensus forward and backward and the blocked aggregation
  (its counters) and its collectives (its ``dispatch.json``), and each
  rank's ``host_<r>/efficiency.json`` ``train_step`` account
  (``collectives``, ``overlap_fraction``, ``critical_path_share``) equal
  between the ranks, ``obs.diff --min-overlap`` passing on ``host_0``
  against itself and failing on a copy set below the floor; (d) one
  data-parallel ``pascal`` epoch (the JAX CLI's widths, a small fixture
  tree, 16-pair batches, each rank 8 pairs of each) on two ranks sharing
  the card, ψ₁'s dropout masks each rank's half of the whole batch's:
  its losses within rel 1e-4 of one process's, each rank's routing and
  consensus launches. (c) and (d) run side by side; the phase runs
  after ``resume`` and before ``keypoints``.

- ``elastic``: the supervisor's distributed half and the fence
  (:func:`phase_elastic`), at ``parallel`` (c)'s flags (full width,
  float32, blocked on), gloo ranks sharing the card: (a) the control:
  ``parallel`` (c)'s two ranks save every epoch, then one rank resumes
  from their epoch-3 step and runs epochs 4-5 at world 1; (b) one
  ``--supervise`` monitor a rank over one obs root, ``peer-death@4`` on
  rank 1: rank 0's monitor exits 0 (``completed``, one restart, attempt
  0's reason ``peer-death:host_1``, ``--row_shards 2 -> 1 (shrink the
  mesh)``, ``ledger.json``'s mesh ``{'shards': 1}``), rank 1's exits 0
  retired, the resumed run names epoch 3, its epoch lines 4-5 and its
  final checkpoint bit-equal to (a)'s, attempt 1's ``dispatch.json``
  with the top-k, both sparse consensus kernels and the blocked
  aggregation launched as kernels, ``obs.report`` printing the elastic
  shrink, and the seconds from the tombstone to the resumed child's
  first finished step; (c): two ranks,
  ``collective-stall@2:120`` on rank 1 under ``--fence-deadline 5``:
  both ranks exit 67 within the deadline plus 30 s of entering the
  fence, each ``hang_report.json`` at fence ``{'phase': 'epoch-fence',
  'step': 2}`` naming the other rank, ``obs.aggregate`` listing the hung
  ranks. (a), (b) and (c) start together, beside ``keypoints``' CLI
  runs (c)-(f) (:func:`elastic_launch`); the phase, right after
  ``keypoints``, waits for them and holds them.

The main paths above run the CLIs' captured steps and the serve engine's
captured buckets; a replay counts the launches its capture made, so the
launch counts per step are the eager step's. Counts filed by a key the
wrappers do not know (a draw's shape, a spline kernel's width) use
stand-in counters that replays advance too (:class:`Tally`).

Output: the numbers, then the ``nvidia-smi`` name/power-limit line, then
one JSON line listing every kernel at its main shape, plus entries for
the top-k and the sparse-consensus forward at 16, 32 and 64 rows
(``topk@16x20000``, ``sparse_consensus_fwd@16x20000`` ...; launches:
their counters read around each serve query of that size, its match and
repeat), the spline kernels at ψ₂'s O=64 (``...@O=64``; launches: the
counters read around each of their calls at that width in the ``train``
phase), the spline records' build, each bf16 variant (``topk_bf16``,
``spline_route_fwd_bf16``, ... ``sparse_consensus_bwd_bf16``; launches:
the bf16 training phases' counters), the draw kernel at its three
main shapes (``rng_normal@...``, ``rng_negatives@...``; launches: the
float32 main paths' draws of that shape) and the ``keypoints`` phase's
shapes (``consensus_fwd@512xNxN,R=128``, ``spline_route_fwd@512xMxO,D=2``
...; launches: the keypoint CLIs' counters at that shape and dtype,
:data:`KP_MAIN`), the routed sums (``corr_project``,
``corr_gather_bwd``; launches: the ``union_route`` phase's routed
steps) (``ms_source`` says
whether its ``ms``, ``plain_ms`` and ``library_ms`` are profiler device
times or CUDA-event times), and last
``{"ok": true, "device": {...}}``. Float32 is exact: TF32 is off for
matrix products and cuDNN.
"""

import argparse
import collections
import concurrent.futures
import contextlib
import copy
import functools
import gc
import importlib
import importlib.util
import io
import itertools
import json
import os
import re
import shutil
import signal
import statistics
import subprocess
import sys
import time
import traceback
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (dense, no sparsity): float32 outside the
# tensor cores, bf16 in them, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

TOPK_SHAPE = (1, 15000, 20000, 256, 10)   # B, N_s, N_t, C, k
SMALL_ROWS = (16, 32, 64)                  # the small buckets' N_s
BUCKETS = '16x48,32x96,64x192,15000x100000'
QUERY_NODES = (16, 23, 32, 41, 48, 57, 64, 16)


def log(msg):
    print(msg, flush=True)


def _host_ms(fn):
    """Host milliseconds of one call of ``fn``."""
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


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


#: ``{kind: count}`` of the compile events the build phase recorded.
BUILD_EVENTS = {}
#: ``{label: timings.json text}`` of the obs dirs the ``obs`` and
#: ``serve_worker`` phases wrote, for the ``lint`` phase's recompile pass.
LINT_OBS = {}
#: The kernel builds :func:`phase_build` started: ``futures`` (source
#: file name -> its ``load_library`` future), ``logged`` (the sources
#: whose build lines are printed), the compile-event ``watcher`` and the
#: start ``t0``.
BUILDS = {}


def phase_build(collation=True, wait=True):
    """Start every CUDA source's build, each ``nvcc`` in a thread of its
    own so that all run side by side, and, with ``collation``, build the
    C++ collation library. With ``wait``, wait for every source;
    otherwise each later phase waits for the sources it needs
    (:func:`await_builds`), so that the first kernel phases run while the
    slowest sources still compile."""
    from dgmc_tpu_torch.obs.registry import CompileWatcher
    from dgmc_tpu_torch.ops.kernels import build
    sources = sorted(f for f in os.listdir(build.CSRC_DIR)
                     if f.endswith('.cu'))
    watcher = CompileWatcher().__enter__()
    pool = concurrent.futures.ThreadPoolExecutor(len(sources))
    BUILDS.update(futures={s: pool.submit(build.load_library, s)
                           for s in sources},
                  logged=set(), watcher=watcher, t0=time.perf_counter())
    pool.shutdown(wait=False)
    log(f'build: {len(sources)} kernel source(s) started side by side')
    if collation:
        from dgmc_tpu_torch import native
        t0 = time.perf_counter()
        if not native.available():
            raise RuntimeError('the C++ collation library did not build '
                               '(g++)')
        log(f'build: native/collate.cpp g++ in '
            f'{time.perf_counter() - t0:.2f}s')
    if wait:
        await_builds()


def await_builds(sources=None):
    """Wait for the builds of ``sources`` (default: every source that
    :func:`phase_build` started) and print each one's ``nvcc`` seconds
    and ``ptxas`` lines once; a failed build raises here, in the phase
    that needs it. When the last build is in, the compile events they
    recorded go to :data:`BUILD_EVENTS`."""
    futures = BUILDS['futures']
    t0 = time.perf_counter()
    for name in sorted(futures if sources is None else sources):
        lib = futures[name].result()
        if name in BUILDS['logged']:
            continue
        BUILDS['logged'].add(name)
        log(f'build: {name} nvcc {lib.build_seconds:.2f}s')
        for line in lib.build_log.splitlines():
            if any(w in line for w in ('registers', 'spill', 'Compiling',
                                       'wgmma')):
                log(f'build: {name} {line.strip()}')
    waited = time.perf_counter() - t0
    if waited >= 0.05:
        log(f'build: waited {waited:.2f}s for '
            f'{", ".join(sorted(sources or futures))}')
    if BUILDS['logged'] == set(futures) and 'watcher' in BUILDS:
        watcher = BUILDS.pop('watcher')
        watcher.close()
        # The compile events a cold ``_build/`` adds (the lint phase's RCP
        # account): one ``nvcc`` event a source it found unbuilt. (A tree
        # before the kind split, under --root, has none.)
        BUILD_EVENTS.update(
            (k, v) for k, v in watcher.summary().get('by_kind', {}).items()
            if k == 'nvcc')
        log(f'build: {len(futures)} kernel source(s) in '
            f'{time.perf_counter() - BUILDS["t0"]:.2f}s wall')


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


def bf16_ulp(x):
    """One bf16 ulp at each value of ``x`` (float32 result): ``2^(e - 8)``
    for ``x = m 2^e``, ``m`` in [0.5, 1) (8 significant bits)."""
    _, e = torch.frexp(x.float())
    return torch.ldexp(torch.ones_like(e, dtype=torch.float32), e - 8)


def hold_bf16_topk(label, h_s, h_t, k, mask=None):
    """The bf16 top-k kernel against its plain bf16 version on continuous
    inputs → max |value error|. Both sum each score in float32, in other
    orders, then round it to bf16, so a score on a rounding boundary may
    land one ulp from the other's; and rounding makes ties common. So:

    - picks: distinct targets in range in every row;
    - indices: equal, except at a position p whose plain score equals, or
      lies one bf16 ulp from, a neighbour's in the plain top-(k+1) (p-1
      or p+1; at p = k-1 that is the k-th against the (k+1)-th): a swap
      inside a near-tie;
    - values: equal wherever the indices agree; where they differ, the
      kernel's value within one bf16 ulp of the plain value at that
      position and of the plain bf16 score of the kernel's own pick
      (float32 products and sums, rounded once).
    """
    from dgmc_tpu_torch.ops.kernels.topk import plain_topk, streaming_topk
    v, i = streaming_topk(h_s, h_t, k, mask)
    torch.cuda.synchronize()
    pv, pi = plain_topk(h_s, h_t, k + 1, mask)
    v, pv = v.float(), pv.float()
    pv_k, pi_k = pv[..., :k], pi[..., :k]
    B, N_t = h_t.shape[0], h_t.shape[1]
    srt = i.sort(dim=-1).values
    if bool((srt[..., 1:] == srt[..., :-1]).any()) or bool(
            ((i < 0) | (i >= N_t)).any()):
        raise AssertionError(f'{label}: repeated or out-of-range picks')
    gap = pv[..., :-1] - pv[..., 1:]
    tie_next = gap <= torch.maximum(bf16_ulp(pv[..., :-1]),
                                    bf16_ulp(pv[..., 1:]))   # p with p+1
    tie_prev = torch.cat([torch.zeros_like(tie_next[..., :1]),
                          tie_next[..., :-1]], dim=-1)      # p with p-1
    diff = i != pi_k
    unexplained = int((diff & ~(tie_next | tie_prev)).any(-1).sum())
    if not torch.equal(v[~diff], pv_k[~diff]):
        raise AssertionError(f'{label}: values differ where the indices '
                             f'agree')
    rows = torch.arange(B, device=h_t.device)[:, None, None]
    own = torch.einsum('bsc,bskc->bsk', h_s.float(),
                       h_t[rows, i.long()].float()).to(BF16).float()
    far = diff & (((v - pv_k).abs() > bf16_ulp(pv_k))
                  | ((v - own).abs() > bf16_ulp(own)))
    err = float((v - pv_k).abs().max())
    log(f'bf16_kernels: topk {label} {tuple(h_s.shape)}x{tuple(h_t.shape)} '
        f'k={k}: {int(diff.any(-1).sum())} rows differ, '
        f'{int(tie_next[..., k - 1].sum())} rows with the k-th and '
        f'(k+1)-th plain scores an ulp or less apart; max |value err| '
        f'{err:.3g}')
    if unexplained:
        raise AssertionError(f'{label}: {unexplained} rows differ outside '
                             f'a near-tie')
    if bool(far.any()):
        raise AssertionError(f'{label}: {int(far.sum())} picks where the '
                             f'indices differ score more than an ulp from '
                             f'the plain version')
    return err


def phase_topk_kernel(result, small):
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
        # Each small row tile, with the segments and their merge, against
        # the serve path's 20000 targets.
        'rows_16x20000': _topk_case(gen, 1, 16, 20000, 32, 10),
        'rows_17x20000_masked': _topk_case(gen, 1, 17, 20000, 32, 10,
                                           mask_p=0.5),
        'rows_33x20000_k_max': _topk_case(gen, 1, 33, 20000, 32, K_MAX),
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

    # The serve path's shapes: small queries (a row tile of their size,
    # the target axis cut into segments and merged) and the whole source
    # KG. Small queries take microseconds on the card, so they are timed
    # by device time (both launches summed) beside the CUDA-event time.
    B, N_s, N_t, C, k = TOPK_SHAPE
    err = 0.0
    for n in SMALL_ROWS:
        h_s, h_t, _, _ = _topk_case(gen, B, n, N_t, C, k, ints=False)
        e = hold_near_ties('random', h_s, h_t, k)
        err = max(err, e)
        got, src = timed({
            'kernel': lambda: streaming_topk(h_s, h_t, k),
            'plain': lambda: plain_topk(h_s, h_t, k),
            'torch.topk(bmm)': lambda: torch.topk(
                torch.bmm(h_s, h_t.transpose(1, 2)), k)})
        b_ms, b_by = work_bound(topk_work(B, n, N_t, C, k))
        log(f'topk_kernel: at {n}x{N_t} C={C} k={k}: bound {b_ms:.4f} ms '
            f'({b_by}); ms per call [{src}] / per-call wall ms (CUDA '
            f'events, median of 10): '
            + ', '.join(f'{key} {v[0]:.4f} / {v[1]:.4f}'
                        for key, v in got.items()))
        small[n].update(name=f'topk@{n}x{N_t}', route='cuda',
                        source='dgmc_tpu_torch/csrc/topk.cu',
                        replaces='dgmc_tpu/ops/pallas/topk.py:40',
                        max_abs_err=e, ms=got['kernel'][0],
                        plain_ms=got['plain'][0], bound_ms=b_ms,
                        bound_by=b_by, library_ms=got['torch.topk(bmm)'][0],
                        ms_source=src)
    h_s, h_t, _, _ = _topk_case(gen, B, N_s, N_t, C, k, ints=False)
    err = max(err, hold_near_ties('random', h_s, h_t, k))

    ms = cuda_ms(lambda: streaming_topk(h_s, h_t, k))
    plain_ms = cuda_ms(lambda: plain_topk(h_s, h_t, k))
    lib_ms = cuda_ms(lambda: torch.topk(
        torch.bmm(h_s, h_t.transpose(1, 2)), k))
    work = topk_work(B, N_s, N_t, C, k)
    flops, nbytes = work['flops'], work['bytes']
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
                   'library_ms': lib_ms, 'ms_source': 'cuda_events'})


#: The model's ``record_function`` stage ranges (JAX's scope names).
RANGES = ('psi1', 'initial_corr', 'topk', 'consensus_iter', 'psi2')


def _profiled(run, calls=1):
    """``(rows, wall_ms)``: the device-side events (kernels, copies,
    memsets) that ``calls`` calls of ``run`` produce under torch.profiler,
    as ``(device_us, name, count)``, and the host wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    run()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        # A record_function range (the model's stage ranges, a step's
        # range) has a device-side twin spanning its kernels: not an op.
        if ev.device_type != DeviceType.CUDA or getattr(
                ev, 'is_user_annotation', False) or ev.key in RANGES \
                or ev.key.startswith('dgmc_step#'):
            continue
        dev_us = getattr(ev, 'self_device_time_total',
                         getattr(ev, 'self_cuda_time_total', 0))
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    return rows, wall_ms


def device_ms(fn, runs=10, tries=3):
    """Device time of one call of ``fn``: the device-side events of
    ``runs`` calls after a warm-up, summed, per call. Unlike
    :func:`cuda_ms` it leaves out the host's launch overhead, which
    dominates a call that takes microseconds on the card. The profiler
    now and then records no device time at all: then it tries again, and
    after ``tries`` empty profiles returns None."""
    for _ in range(tries):
        rows, _ = _profiled(fn, runs)
        if rows:
            return sum(r[0] for r in rows) / 1e3 / runs
    return None


def timed(calls):
    """``(times, source)`` for a dict of calls, ``times[k] = (ms,
    wall_ms)``: ``ms`` is the device time per call where the profiler
    records one for every call, else the per-call CUDA-event time for
    every call, so that a kernel, its plain version and its library call
    stand on one yardstick; ``source`` (``'profiler'`` or
    ``'cuda_events'``) says which, and goes into the JSON line."""
    wall = {k: cuda_ms(f) for k, f in calls.items()}
    dev = {k: device_ms(f) for k, f in calls.items()}
    if any(v is None for v in dev.values()):
        return {k: (w, w) for k, w in wall.items()}, 'cuda_events'
    return {k: (dev[k], wall[k]) for k in calls}, 'profiler'


def profile(run, label, top=8):
    """Device time of one call of ``run`` by operator (torch.profiler):
    the breakdown behind a latency or step time, the ``top`` rows.
    Informational: a profiler that records no device time prints 'not
    measured'. Returns every row, ``(device_us, name, count)``, largest
    first."""
    rows, wall_ms = _profiled(run)
    busy_ms = sum(r[0] for r in rows) / 1e3
    if not rows:
        log(f'profile: {label}: device time not measured (the profiler '
            f'recorded none)')
        return rows
    rows.sort(reverse=True)
    log(f'profile: {label}: wall {wall_ms:.3f} ms under the profiler, '
        f'device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), '
        f'{sum(r[2] for r in rows)} device ops')
    for dev_us, key, count in rows[:top]:
        log(f'profile: {label}:   {dev_us / 1e3:9.3f} ms '
            f'{100 * dev_us / 1e3 / busy_ms:5.1f}%  x{count:<5d} '
            f'{key[:70]}')
    return rows


def bound(flops, nbytes, peak=PEAK_F32_FLOPS):
    """``(bound_ms, bound_by)``: the larger of operations at the peak rate
    of their type (float32 unless told) and bytes at the memory rate."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            'operations' if t_ops >= t_bytes else 'bytes')


def work_bound(work, peak=PEAK_F32_FLOPS):
    """:func:`bound` of a kernel's work (the ``*_work`` functions of its
    wrapper module: ``{'flops', 'bytes', ...}``)."""
    return bound(work['flops'], work['bytes'], peak)


def topk_work(*args):
    """``ops/kernels/topk.py``'s ``topk_work``: the search's least work."""
    from dgmc_tpu_torch.ops.kernels.topk import topk_work as work
    return work(*args)


def consensus_work(*args):
    """``ops/kernels/consensus.py``'s ``consensus_work``: the dense delta's
    least work in the factored form."""
    from dgmc_tpu_torch.ops.kernels.consensus import consensus_work as work
    return work(*args)


def hold_close(label, got, want):
    """Kernel against plain on float32 inputs: rtol 1e-5 and atol 1e-5 x
    the largest |value| (the two sum in other orders) → max |err|."""
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    if not torch.allclose(got, want, rtol=1e-5, atol=1e-5 * scale):
        raise AssertionError(f'{label}: kernel and plain version differ by '
                             f'{err} (max |plain| {scale})')
    return err


def hold_ulp(label, got, want):
    """A bf16 kernel output against its plain bf16 version on continuous
    inputs: within one bf16 ulp of the larger of the two (both sum in
    float32 in other orders and round once, so a sum on a rounding
    boundary may round the other way), plus 1e-5 x max|out| for sums
    that cancel to nearly 0 → max |err|."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if not err.numel():
        return 0.0
    ulp = torch.ldexp(torch.ones_like(w),
                      torch.frexp(torch.maximum(g.abs(), w.abs()))[1] - 8)
    bad = err > ulp + 1e-5 * float(w.abs().max())
    if bad.any():
        raise AssertionError(f'{label}: {int(bad.sum())} of {err.numel()} '
                             f'bf16 values differ by more than an ulp (max '
                             f'|err| {float(err.max())})')
    return float(err.max())


def hold_equal(label, fn, plain):
    """Bit-equal to the plain version, and a repeat bit-identical."""
    out = fn()
    torch.cuda.synchronize()
    if not torch.equal(out, plain()):
        raise AssertionError(f'{label}: kernel differs from the plain '
                             f'version')
    if not torch.equal(out, fn()):
        raise AssertionError(f'{label}: a repeat gave another result')
    return out


def _train_args(extra=()):
    from dgmc_tpu_torch.experiments import pascal_pf
    return pascal_pf.parse_args(['--seed', '0', '--precision', 'f32',
                                 *extra])


def _spline_exact(gen, B, N, E, O, masked, D=2):
    """Exact inputs: small-integer t, dyadic basis, and g an integer
    multiple of each node's degree (so g / deg is exact); ``D``
    pseudo-coordinates (2^D slots an edge, 5^D knot rows a node)."""
    from dgmc_tpu_torch.ops.kernels.spline import Routing
    A, M = 2 ** D, N * 5 ** D
    t = torch.randint(-3, 4, (B, M, O), generator=gen).float()
    basis = torch.randint(0, 5, (B, E, A), generator=gen).float() / 4
    flat = torch.randint(0, M, (B, E, A), generator=gen)
    rcv = torch.randint(0, N, (B, E), generator=gen)
    mask = torch.rand(B, E, generator=gen) > masked
    deg = torch.zeros(B, N).scatter_add_(1, rcv, mask.float())
    g = torch.randint(-3, 4, (B, N, O), generator=gen).float() * deg.clamp(
        min=1)[..., None]
    dev = torch.device('cuda')
    return (t.to(dev), g.to(dev), basis.to(dev),
            Routing(flat.to(dev), rcv.to(dev), mask.to(dev), N, M))


def _routing_matrix(basis, routing, transpose=False):
    """The block-diagonal routing matrix ``[B*N, B*M]`` (basis / degree
    weights; its transpose for the gradient) as a sparse CSR tensor: the
    ``torch.sparse.mm`` yardstick."""
    B, E, A = routing.flat.shape
    N, M = routing.num_nodes, routing.num_rows
    _, offsets = routing.receiver_csr()
    deg = (offsets[1:] - offsets[:-1])[:B * N].float().clamp(min=1)
    b = torch.arange(B, device=basis.device)[:, None, None]
    rows = (b * N + routing.receivers[..., None]).expand(B, E, A)
    cols = b * M + routing.flat
    keep = routing.edge_mask[..., None].expand(B, E, A)
    vals = basis / deg[rows]
    idx = torch.stack([rows[keep], cols[keep]])
    shape = (B * N, B * M)
    if transpose:
        idx, shape = idx.flip(0), shape[::-1]
    return torch.sparse_coo_tensor(idx, vals[keep], shape,
                                   check_invariants=False).coalesce(
        ).to_sparse_csr()


def _spline_work(basis, routing, O, elem=4, peak=PEAK_F32_FLOPS):
    """The bounds of the forward and of ``d_t`` on this batch's routing
    (``route_work`` of ``ops/kernels/spline.py``: forward reads each
    touched t row once, the gradient writes all of d_t; ``elem`` bytes a
    value of t, g and the outputs: 4, or 2 for bf16; operations at
    ``peak``)."""
    from dgmc_tpu_torch.ops.kernels.spline import route_work
    work = route_work(basis, routing, O, elem)
    slots, rows = work['slots'], work['rows']
    log(f'spline_kernel: O={O}: {slots} real slots gather {rows} distinct t '
        f'rows ({elem * slots * O / 1e6:.1f} MB of t rows read, '
        f'{elem * rows * O / 1e6:.1f} MB distinct, {elem}-byte values)')
    return work_bound(work, peak), work_bound(work['bwd'], peak)


def phase_spline_kernel(fwd_res, bwd_res, fwd64, bwd64, rec_res):
    from dgmc_tpu_torch.models.spline import spline_routing
    from dgmc_tpu_torch.ops.graph import GraphBatch
    from dgmc_tpu_torch.ops.kernels.spline import (Routing, build_records,
                                                   plain_edge_records,
                                                   plain_route_aggregate,
                                                   plain_route_d_t,
                                                   plain_slot_records,
                                                   route_d_t, route_fwd)
    from dgmc_tpu_torch.experiments import pascal_pf
    gen = torch.Generator().manual_seed(1)

    def hold_records(label, basis, routing):
        got = build_records(routing, basis)
        torch.cuda.synchronize()
        for kind, have, plain in (
                ('edge', got[:2], plain_edge_records),
                ('slot', got[2:], plain_slot_records)):
            if not all(map(torch.equal, have, plain(routing, basis))):
                raise AssertionError(f'{kind} records {label}: the kernel '
                                     f'differs from the plain version')

    exact = {'all_masked': (2, 11, 40, 16, 1.01),
             'm_275_rows': (3, 11, 50, 33, 0.2),
             'batch_1': (1, 24, 80, 64, 0.2),
             'no_edges': (2, 6, 0, 8, 0.0),
             'train_width': (64, 80, 640, 256, 0.3)}
    for name, case in exact.items():
        t, g, basis, routing = _spline_exact(gen, *case)
        out = hold_equal(f'spline fwd {name}',
                         lambda: route_fwd(t, basis, routing),
                         lambda: plain_route_aggregate(t, basis, routing))
        hold_equal(f'spline d_t {name}',
                   lambda: route_d_t(g, basis, routing),
                   lambda: plain_route_d_t(g, basis, routing))
        hold_records(name, basis, routing)
        if name == 'all_masked' and bool(out.any()):
            raise AssertionError('an all-masked node did not give zeros')
        log(f'spline_kernel: case {name} B,N,E,O={case[:4]}: fwd, d_t, '
            f'edge and slot records bit-equal, repeats identical')
    # A hub: 30% of the slots point at row 7 of each graph (~770 slots,
    # more than the d_t kernel stages per warp), beside empty rows.
    for O in (64, 256):
        t, g, basis, routing = _spline_exact(gen, 4, 80, 640, O, 0.3)
        flat = routing.flat.clone()
        flat[torch.rand(flat.shape, generator=gen).cuda() < 0.3] = 7
        routing = Routing(flat, routing.receivers, routing.edge_mask, 80,
                          routing.num_rows)
        hold_equal(f'spline d_t hub O={O}',
                   lambda: route_d_t(g, basis, routing),
                   lambda: plain_route_d_t(g, basis, routing))
        hold_records(f'hub O={O}', basis, routing)
        _, offsets = routing.slot_records(basis)
        counts = offsets[1:] - offsets[:-1]
        log(f'spline_kernel: case hub O={O}: d_t bit-equal, repeat '
            f'identical (largest row {int(counts.max())} slots, '
            f'{int((counts == 0).sum())} of {counts.numel()} rows empty)')
    # A hub receiver: 30% of the edges go to node 7, the others to the
    # first 60 nodes (20 rows of each graph without an edge), O = 3 (the
    # 4-byte path), 64 and 256.
    for O in (3, 64, 256):
        t, _, basis, routing = _spline_exact(gen, 4, 80, 640, O, 0.3)
        rcv = torch.randint(0, 60, (4, 640), generator=gen)
        rcv[torch.rand(4, 640, generator=gen) < 0.3] = 7
        routing = Routing(routing.flat, rcv.cuda(), routing.edge_mask, 80,
                          routing.num_rows)
        out = hold_equal(f'spline fwd hub receiver O={O}',
                         lambda: route_fwd(t, basis, routing),
                         lambda: plain_route_aggregate(t, basis, routing))
        hold_records(f'hub receiver O={O}', basis, routing)
        _, offsets = routing.edge_records(basis)
        counts = (offsets[1:] - offsets[:-1])[:4 * 80]
        if out.reshape(4 * 80, O)[counts == 0].any():
            raise AssertionError('a row without an edge did not give zeros')
        log(f'spline_kernel: case hub receiver O={O}: fwd bit-equal, repeat '
            f'identical (largest row {int(counts.max())} slots, '
            f'{int((counts == 0).sum())} of {counts.numel()} rows empty)')

    # The four SplineConv shapes of the training path on a real batch.
    args = _train_args()
    _, loader, _ = pascal_pf.build(args)
    batch = next(iter(loader))
    graph = GraphBatch.from_numpy(batch.s, 'cuda')
    basis, routing = spline_routing(graph, 5)
    B, N = graph.x.shape[:2]
    M = routing.num_rows
    hold_records('training batch', basis, routing)
    # Both kernels' records, once per routing and basis (records_work).
    from dgmc_tpu_torch.ops.kernels.spline import records_work
    E, A = routing.flat.shape[1:]
    rec_bytes = records_work(routing)['bytes']
    rec_ms, rec_by = bound(0.0, rec_bytes)
    got, src = timed({
        'kernel': lambda: build_records(routing, basis),
        'plain': lambda: (plain_edge_records(routing, basis),
                          plain_slot_records(routing, basis))})
    log(f'spline_kernel: edge and slot records [{B}, {E}, {A}] slots: bound '
        f'{rec_ms:.4f} ms ({rec_by}, {rec_bytes / 1e6:.2f} MB); ms per call '
        f'[{src}] / per-call wall ms (CUDA events, median of 10): '
        + ', '.join(f'{k} {v[0]:.4f} / {v[1]:.4f}' for k, v in got.items()))
    rec_res.update(name='spline_records', route='cuda',
                   source='dgmc_tpu_torch/csrc/spline.cu',
                   replaces='dgmc_tpu/ops/pallas/spline.py:72',
                   max_abs_err=0.0, ms=got['kernel'][0],
                   plain_ms=got['plain'][0], bound_ms=rec_ms,
                   bound_by=rec_by, library_ms=None, ms_source=src)
    for label, O in (('psi_1 conv_0/1', args.dim), ('psi_2 conv_0/1',
                                                    args.rnd_dim)):
        err_f = err_b = 0.0
        for layer in (0, 1):
            t = torch.randn(B, M, O, generator=gen).cuda()
            g = torch.randn(B, N, O, generator=gen).cuda()
            out = route_fwd(t, basis, routing)
            torch.cuda.synchronize()
            err_f = max(err_f, hold_close(
                f'spline fwd {label}', out,
                plain_route_aggregate(t, basis, routing)))
            err_b = max(err_b, hold_close(
                f'spline d_t {label}', route_d_t(g, basis, routing),
                plain_route_d_t(g, basis, routing)))
            if not torch.equal(out, route_fwd(t, basis, routing)):
                raise AssertionError('spline fwd: a repeat differs')
        log(f'spline_kernel: {label} [{B}, {M}, {O}] on a RandomGraphPairs '
            f'batch: within tolerance (max |err| fwd {err_f:.3g}, d_t '
            f'{err_b:.3g})')

        (fb, fby), (bb, bby) = _spline_work(basis, routing, O)
        R = _routing_matrix(basis, routing)
        RT = _routing_matrix(basis, routing, transpose=True)
        t2, g2 = t.reshape(B * M, O), g.reshape(B * N, O)
        lib_err = hold_close('sparse.mm yardstick', torch.sparse.mm(
            R, t2).reshape(B, N, O), plain_route_aggregate(t, basis,
                                                           routing))
        calls = {'fwd': lambda: route_fwd(t, basis, routing),
                 'fwd plain': lambda: plain_route_aggregate(t, basis,
                                                            routing),
                 'fwd sparse.mm': lambda: torch.sparse.mm(R, t2),
                 'd_t': lambda: route_d_t(g, basis, routing),
                 'd_t plain': lambda: plain_route_d_t(g, basis, routing),
                 'd_t sparse.mm': lambda: torch.sparse.mm(RT, g2)}
        got, src = timed(calls)
        dev = {k: v[0] for k, v in got.items()}
        log(f'spline_kernel: O={O}, bound fwd {fb:.4f} ms ({fby}), d_t '
            f'{bb:.4f} ms ({bby}); sparse.mm agrees (max |err| '
            f'{lib_err:.3g}); ms per call [{src}] / per-call wall ms (CUDA '
            f'events, median of 10): '
            + ', '.join(f'{k} {v[0]:.4f} / {v[1]:.4f}'
                        for k, v in got.items()))
        # The JSON line carries ψ₁'s width (O=256) under the kernels'
        # names and ψ₂'s (O=64) as extra entries.
        f_res, b_res = ((fwd_res, bwd_res) if O == args.dim
                        else (fwd64, bwd64))
        f_res.update(ms=dev['fwd'], plain_ms=dev['fwd plain'],
                     bound_ms=fb, bound_by=fby, max_abs_err=err_f,
                     library_ms=dev['fwd sparse.mm'], ms_source=src)
        b_res.update(ms=dev['d_t'], plain_ms=dev['d_t plain'],
                     bound_ms=bb, bound_by=bby, max_abs_err=err_b,
                     library_ms=dev['d_t sparse.mm'], ms_source=src)
    for res, name, line in (
            (fwd_res, 'spline_route_fwd', 72),
            (bwd_res, 'spline_route_bwd', 96),
            (fwd64, f'spline_route_fwd@O={args.rnd_dim}', 72),
            (bwd64, f'spline_route_bwd@O={args.rnd_dim}', 96)):
        res.update(name=name, route='cuda',
                   source='dgmc_tpu_torch/csrc/spline.cu',
                   replaces=f'dgmc_tpu/ops/pallas/spline.py:{line}')


def launch_split(fn, runs=10):
    """Device ms per call of each kernel (and copy) that ``fn`` launches,
    by name (``torch.profiler``, ``runs`` calls), or None where the
    profiler recorded nothing."""
    rows, _ = _profiled(fn, runs)
    out = {}
    for dev_us, key, _ in rows:
        m = re.search(r'(\w+)(?:<[^>(]*>)?\(', key)
        name = m.group(1) if m else key[:40]
        out[name] = out.get(name, 0.0) + dev_us / 1e3 / runs
    return out or None


def fmt_split(split):
    if split is None:
        return 'not measured'
    return ', '.join(f'{k} {v:.4f}' for k, v in sorted(
        split.items(), key=lambda kv: -kv[1]))


def phase_consensus_kernel(result):
    from dgmc_tpu_torch.ops.kernels import consensus
    from dgmc_tpu_torch.ops.kernels.consensus import (R_MAX,
                                                      consensus_backward,
                                                      consensus_fwd,
                                                      launch_plan,
                                                      plain_consensus)
    gen = torch.Generator().manual_seed(2)

    def case(B, N_s, N_t, R, ints):
        def draw(*shape, scale=1.0):
            if ints:
                return torch.randint(-2, 3, shape, generator=gen).float()
            return scale * torch.randn(*shape, generator=gen)
        return [a.cuda() for a in (
            draw(B, N_s, R), draw(B, N_t, R), draw(R, R, scale=R ** -0.5),
            draw(R, scale=0.1), draw(R, 1, scale=R ** -0.5),
            draw(1, scale=0.1))]

    shapes = {'ragged': (2, 20, 37, 8), 'one_pair': (1, 1, 1, 1),
              'train_width': (64, 80, 80, 64), 'r_max': (2, 33, 65, R_MAX),
              'r_33': (3, 80, 80, 33)}
    for name, shape in shapes.items():
        a = case(*shape, ints=True)
        hold_equal(f'consensus {name}', lambda: consensus_fwd(*a),
                   lambda: plain_consensus(*a))
        log(f'consensus_kernel: case {name} B,N_s,N_t,R={shape}: bit-equal, '
            f'repeat identical')
    err = 0.0
    for name in ('ragged', 'r_max', 'train_width'):
        a = case(*shapes[name], ints=False)
        out = consensus_fwd(*a)
        torch.cuda.synchronize()
        err = max(err, hold_close(f'consensus {name}', out,
                                  plain_consensus(*a)))
    B, N_s, N_t, R = shapes['train_width']
    got, src = timed({'kernel': lambda: consensus_fwd(*a),
                      'plain': lambda: plain_consensus(*a)})
    (ms, wall), (plain_ms, wall_plain) = got['kernel'], got['plain']
    work = consensus_work(B, N_s, N_t, R)
    flops, nbytes = work['flops'], work['bytes']
    b_ms, b_by = bound(flops, nbytes)
    log(f'consensus_kernel: float32 within tolerance (max |err| {err:.3g}); '
        f'at [{B}, {N_s}, {N_t}] R={R}, ms per call [{src}] / per-call '
        f'wall ms (CUDA events, median of 10): kernel {ms:.4f} / '
        f'{wall:.4f}, plain {plain_ms:.4f} / {wall_plain:.4f}; '
        f'bound {b_ms:.4f} ms '
        f'({flops / 1e9:.3f} GFLOP factored, against '
        f'{2.0 * B * N_s * N_t * R * R / 1e9:.2f} for the per-pair product; '
        f'{nbytes / 1e6:.2f} MB); no single PyTorch call computes it')
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f'consensus_kernel: launch plan {launch_plan(B, N_s, N_t, sms)} '
        f'(TS, TT) on {sms} SMs; device ms per call by launch: '
        f'{fmt_split(launch_split(lambda: consensus_fwd(*a)))}')
    # The plan against other tiles at the same shape (informational).
    lib = consensus._library()
    u_s, u_t = torch.empty_like(a[0]), torch.empty_like(a[1])
    out = torch.empty(B, N_s, N_t, device='cuda')
    want = consensus_fwd(*a)
    sweep = []
    for TS, TT in ((40, 80), (80, 40), (20, 80), (40, 40), (16, 80),
                   (24, 80), (20, 40)):
        def tiled():
            err = lib.dgmc_consensus_fwd_f32(
                *(x.data_ptr() for x in a), u_s.data_ptr(), u_t.data_ptr(),
                out.data_ptr(), B, N_s, N_t, R, TS, TT, 0,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f'tile {TS}x{TT}: CUDA error {err}')
        tiled()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f'consensus tile {TS}x{TT} differs')
        split = launch_split(tiled) or {}
        sweep.append(f'{TS}x{TT} {split.get("consensus_pairs", 0):.4f}')
    log(f'consensus_kernel: consensus_pairs device ms by tile (TSxTT), '
        f'bit-equal to the plan\'s: ' + ', '.join(sweep))
    # The dense step's plain backward (the tile recompute, as JAX's jnp
    # backward), at the same shape: is it worth a kernel of its own?
    g = torch.randn(B, N_s, N_t, generator=gen).cuda()
    bwd, src_b = timed({'backward': lambda: consensus_backward(*a[:5], g)})
    split_b = launch_split(lambda: consensus_backward(*a[:5], g), runs=3)
    log(f'consensus_kernel: plain consensus_backward at [{B}, {N_s}, {N_t}] '
        f'R={R}: {bwd["backward"][0]:.4f} ms per call [{src_b}] / '
        f'{bwd["backward"][1]:.4f} wall (CUDA events), x10 per dense step; '
        f'by op: {fmt_split(split_b)}')
    result.update(name='consensus_fwd', route='cuda',
                  source='dgmc_tpu_torch/csrc/consensus.cu',
                  replaces='dgmc_tpu/ops/pallas/consensus.py:49',
                  max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                  bound_by=b_by, library_ms=None, ms_source=src)


def _sc_case(gen, B, N_s, N_t, K, R, dup=0.0, ints=True):
    """Inputs of the sparse consensus kernels: small integers (exact) or
    float32 at the model's scales; ``dup`` of the slots point at one
    target, or with ``dup='hub'`` the targets follow a Zipf law as top-k
    hubs do (a few targets in thousands of lists, most in none). Returns
    ``(o_s, o_t, w1, b1, w2, b2)``, the Shortlist and the output gradient
    g, on the card."""
    from dgmc_tpu_torch.ops.shortlist import Shortlist

    def draw(*shape, scale=1.0, lo=-2, hi=3):
        if ints:
            return torch.randint(lo, hi, shape, generator=gen).float()
        return scale * torch.randn(*shape, generator=gen)
    if dup == 'hub':
        rng = np.random.RandomState(int(torch.randint(1 << 30, (1,),
                                                      generator=gen)))
        idx = torch.from_numpy(np.minimum(rng.zipf(1.3, (B, N_s, K)) - 1,
                                          N_t - 1))
    else:
        idx = torch.randint(0, N_t, (B, N_s, K), generator=gen)
        idx[torch.rand(B, N_s, K, generator=gen) < dup] = N_t // 2
    floats = [draw(B, N_s, R), draw(B, N_t, R), draw(R, R, scale=R ** -0.5),
              draw(R, scale=0.1), draw(R, 1, scale=R ** -0.5),
              draw(1, scale=0.1), draw(B, N_s, K, lo=-1, hi=2)]
    floats = [a.cuda() for a in floats]
    return floats[:6], Shortlist(idx.cuda(), N_t), floats[6]


def _sc_autograd(args, sl, g):
    """Gradients of the unfused plain form by autograd."""
    from dgmc_tpu_torch.ops.kernels.sparse_consensus import (
        plain_fused_candidate_delta)
    ts = [a.clone().requires_grad_() for a in args]
    out = plain_fused_candidate_delta(ts[0], ts[1], sl, *ts[2:])
    return torch.autograd.grad((out * g).sum(), ts)


SC_GRADS = ('d_o_s', 'd_o_t', 'd_w1', 'd_b1', 'd_w2', 'd_b2')


def _sc_work(B, N_s, N_t, K, R, T=None, elem=4):
    """``((fwd_flops, fwd_bytes), (bwd_flops, bwd_bytes))`` of ``sc_work``
    (``ops/kernels/sparse_consensus.py``: the least work of the function
    in the factored form)."""
    from dgmc_tpu_torch.ops.kernels.sparse_consensus import sc_work
    work = sc_work(B, N_s, N_t, K, R, T, elem)
    return ((work['flops'], work['bytes']),
            (work['bwd']['flops'], work['bwd']['bytes']))


def _sc_plain_mask(args, sl):
    """The ReLU mask as the forward writes it, from the plain factored
    form (for bf16 inputs rounded as the kernels round: u, then pre): bit
    l of word c of a candidate is ``pre > 0`` in channel ``l + 32 c``,
    ``[B*N_s*K, ceil(R/32)]`` int32."""
    o_s, o_t, w1, b1 = (a.float() for a in args[:4])
    dt = args[0].dtype

    def rnd(x):
        return x.to(dt).float()
    R = o_s.shape[2]
    nc = -(-R // 32)
    pre = rnd(rnd(rnd(o_s @ w1) + b1)[:, :, None, :]
              - sl.gather(rnd(o_t @ w1)))
    bits = torch.zeros(pre.numel() // R, 32 * nc, dtype=torch.int64,
                       device=pre.device)
    bits[:, :R] = (pre.reshape(-1, R) > 0).long()
    words = (bits.reshape(-1, nc, 32) << torch.arange(
        32, device=pre.device)).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).int()


def _touched_rows(sl):
    """Target rows of the flattened batch that a shortlist points at."""
    from dgmc_tpu_torch.ops.kernels.sparse_consensus import touched_rows
    return touched_rows(sl)


def phase_sparse_consensus_kernel(fwd_res, bwd_res, serve_res):
    from dgmc_tpu_torch.ops.graph import gather_nodes
    from dgmc_tpu_torch.ops.kernels import dispatch
    from dgmc_tpu_torch.ops.kernels.sparse_consensus import (
        plain_fused_candidate_delta, plain_sparse_consensus_bwd,
        plain_sparse_consensus_delta, plain_sparse_consensus_fwd,
        sparse_consensus_bwd, sparse_consensus_delta, sparse_consensus_fwd)
    gen = torch.Generator().manual_seed(3)
    exact = {'duplicates': (2, 1000, 300, 20, 32, 0.9),
             'one_row_touched': (1, 1, 7, 1, 32, 0.0),
             'k_1': (2, 300, 90, 1, 32, 0.0),
             'r_max': (2, 200, 150, 10, 128, 0.2),
             'batch_2': (2, 1500, 2000, 20, 32, 0.0),
             'hub': (1, 15000, 20000, 20, 32, 'hub'),
             'k_40': (2, 300, 500, 40, 33, 0.3),
             # fewer candidates than target rows: u_t of the touched rows
             'duplicates_touched': (2, 100, 5000, 20, 32, 0.9),
             'r_max_touched': (2, 20, 1500, 10, 128, 0.2),
             'hub_touched': (1, 1000, 30000, 20, 32, 'hub'),
             'k_40_touched': (2, 30, 5000, 40, 33, 0.3)}
    for name, case in exact.items():
        args, sl, g = _sc_case(gen, *case)
        for plain in (plain_fused_candidate_delta, plain_sparse_consensus_fwd):
            hold_equal(f'sparse consensus fwd {name} vs {plain.__name__}',
                       lambda: sparse_consensus_fwd(args[0], args[1], sl,
                                                    *args[2:]),
                       lambda: plain(args[0], args[1], sl, *args[2:]))
        form = dispatch.decisions()['sparse_consensus_fwd']['reason']
        if ('touched rows' in form) != name.endswith('_touched'):
            raise AssertionError(f'sparse consensus fwd {name}: dispatch '
                                 f'{form!r}')
        # The backward takes the forward's u and ReLU mask, as the main
        # path hands them over; the plain version forms u itself.
        out, state = sparse_consensus_fwd(args[0], args[1], sl, *args[2:],
                                          return_state=True)
        if not torch.equal(out, plain_sparse_consensus_fwd(
                args[0], args[1], sl, *args[2:])):
            raise AssertionError(f'sparse consensus fwd {name}: the delta '
                                 f'written with the state differs')
        if not torch.equal(state[2], _sc_plain_mask(args, sl)):
            raise AssertionError(f'sparse consensus fwd {name}: the ReLU '
                                 f'mask differs from pre > 0')
        got = sparse_consensus_bwd(*args[:2], sl, *args[2:5], g, state)
        torch.cuda.synchronize()
        again = sparse_consensus_bwd(*args[:2], sl, *args[2:5], g, state)
        for label, want in (('plain', plain_sparse_consensus_bwd(
                *args[:2], sl, *args[2:5], g)),
                ('autograd', _sc_autograd(args, sl, g))):
            for n, a, b, c in zip(SC_GRADS, got, want, again):
                if not torch.equal(a, b):
                    raise AssertionError(
                        f'sparse consensus bwd {name}: {n} differs from '
                        f'the {label} version')
                if not torch.equal(a, c):
                    raise AssertionError(
                        f'sparse consensus bwd {name}: {n} differs on a '
                        f'repeat')
        log(f'sparse_consensus_kernel: case {name} B,N_s,N_t,K,R,dup={case} '
            f'({form.split(": ")[0].removeprefix("auto-cuda, ")}): fwd '
            f'bit-equal (unfused and factored plain forms; with and without '
            f'the state), ReLU mask equal to the plain pre > 0, all six '
            f'gradients from its state bit-equal (plain, which forms u, and '
            f'autograd), repeats identical')
    # The narrow form: pre-gathered candidates under the identity
    # shortlist, against autograd of the unfused plain form.
    args, sl, g = _sc_case(gen, 2, 300, 300 * 6, 6, 32)
    cand = args[1].reshape(2, 300, 6, 32)
    ts = [a.clone().requires_grad_() for a in (args[0], cand, *args[2:])]
    got = torch.autograd.grad(sparse_consensus_delta(*ts), ts, g)
    want = torch.autograd.grad(plain_sparse_consensus_delta(*ts), ts, g)
    if not all(map(torch.equal, got, want)):
        raise AssertionError('sparse consensus narrow form: a gradient '
                             'differs from autograd of the plain form')
    log('sparse_consensus_kernel: case identity (narrow form, [2, 300, 6, '
        '32]): all six gradients bit-equal to autograd of the unfused form')

    err_f = err_b = 0.0
    for K in (20, 10):
        B, N_s, N_t, R = 1, 15000, 20000, 32
        args, sl, g = _sc_case(gen, B, N_s, N_t, K, R, ints=False)
        out = sparse_consensus_fwd(args[0], args[1], sl, *args[2:])
        torch.cuda.synchronize()
        for plain in (plain_fused_candidate_delta, plain_sparse_consensus_fwd):
            err_f = max(err_f, hold_close(
                f'sparse consensus fwd K={K} vs {plain.__name__}', out,
                plain(args[0], args[1], sl, *args[2:])))
        out_s, state = sparse_consensus_fwd(args[0], args[1], sl, *args[2:],
                                            return_state=True)
        got = sparse_consensus_bwd(*args[:2], sl, *args[2:5], g, state)
        want = plain_sparse_consensus_bwd(*args[:2], sl, *args[2:5], g)
        auto = _sc_autograd(args, sl, g)
        again = sparse_consensus_bwd(*args[:2], sl, *args[2:5], g, state)
        rel_auto = []
        for n, a, b, c, d in zip(SC_GRADS, got, want, again, auto):
            err_b = max(err_b, hold_close(f'sparse consensus {n} K={K}', a,
                                          b))
            if not torch.equal(a, c):
                raise AssertionError(f'sparse consensus {n}: a repeat '
                                     f'differs')
            rel_auto.append(float((a - d).abs().max() / d.abs().max()))
        for o in (out_s, sparse_consensus_fwd(args[0], args[1], sl,
                                              *args[2:])):
            if not torch.equal(out, o):
                raise AssertionError('sparse consensus fwd: a repeat (with '
                                     'or without the state) differs')
        log(f'sparse_consensus_kernel: float32 [1, {N_s}, {K}, {R}] over '
            f'{N_t} targets: fwd and gradients within tolerance (max |err| '
            f'fwd {err_f:.3g}, bwd {err_b:.3g}), repeats bit-identical; '
            f'|kernel - autograd of the unfused form| / max per gradient '
            + ', '.join(f'{n} {v:.2g}' for n, v in zip(SC_GRADS, rel_auto)))
        (ff, fb), (bf, bb) = _sc_work(B, N_s, N_t, K, R, _touched_rows(sl))
        (f_ms, f_by), (b_ms, b_by) = bound(ff, fb), bound(bf, bb)
        calls = {
            'fwd': lambda: sparse_consensus_fwd(args[0], args[1], sl,
                                                *args[2:]),
            'fwd with state': lambda: sparse_consensus_fwd(
                args[0], args[1], sl, *args[2:], return_state=True),
            'fwd plain': lambda: plain_fused_candidate_delta(
                args[0], args[1], sl, *args[2:]),
            'fwd plain factored': lambda: plain_sparse_consensus_fwd(
                args[0], args[1], sl, *args[2:]),
            'bwd': lambda: sparse_consensus_bwd(*args[:2], sl, *args[2:5],
                                                g, state),
            'bwd plain': lambda: plain_sparse_consensus_bwd(
                *args[:2], sl, *args[2:5], g)}
        got_t, src = timed(calls)
        log(f'sparse_consensus_kernel: K={K}: bound fwd {f_ms:.4f} ms '
            f'({f_by}; {ff / 1e9:.3f} GFLOP factored, {fb / 1e6:.2f} MB), '
            f'bwd {b_ms:.4f} ms ({b_by}; {bf / 1e9:.3f} GFLOP, '
            f'{bb / 1e6:.2f} MB); ms per call [{src}] / per-call wall ms '
            f'(CUDA events, median of 10): '
            + ', '.join(f'{k} {v[0]:.4f} / {v[1]:.4f}'
                        for k, v in got_t.items()))
        for k in ('fwd', 'fwd with state', 'bwd'):
            log(f'sparse_consensus_kernel: K={K}: {k}, device ms per call '
                f'by launch: {fmt_split(launch_split(calls[k]))}')
        if K == 20:   # the JSON line carries the training shape, as the
            # training path calls the forward: writing the state
            fwd_res.update(ms=got_t['fwd with state'][0],
                           plain_ms=got_t['fwd plain'][0],
                           bound_ms=f_ms, bound_by=f_by, ms_source=src)
            bwd_res.update(ms=got_t['bwd'][0], plain_ms=got_t['bwd plain'][0],
                           bound_ms=b_ms, bound_by=b_by, ms_source=src)
    fwd_res.update(name='sparse_consensus_fwd', route='cuda',
                   source='dgmc_tpu_torch/csrc/sparse_consensus.cu',
                   replaces='dgmc_tpu/ops/pallas/sparse_consensus.py:62',
                   max_abs_err=err_f, library_ms=None)

    # The serve query shapes: 16, 32 and 64 rows x K = 10 over the 20000
    # corpus rows, R = 32 (float32, uniform shortlists). The rule forms u_t
    # of the touched rows only.
    for n in SMALL_ROWS:
        B, N_t, K, R = 1, 20000, 10, 32
        args, sl, _ = _sc_case(gen, B, n, N_t, K, R, ints=False)
        out = sparse_consensus_fwd(args[0], args[1], sl, *args[2:])
        torch.cuda.synchronize()
        reason = dispatch.decisions()['sparse_consensus_fwd']['reason']
        if 'touched rows' not in reason:
            raise AssertionError(f'serve shape {n}: dispatch {reason!r}')
        err = 0.0
        for plain in (plain_fused_candidate_delta, plain_sparse_consensus_fwd):
            err = max(err, hold_close(
                f'sparse consensus fwd {n}x{N_t} vs {plain.__name__}', out,
                plain(args[0], args[1], sl, *args[2:])))
        if not torch.equal(out, sparse_consensus_fwd(args[0], args[1], sl,
                                                     *args[2:])):
            raise AssertionError(f'serve shape {n}: a repeat differs')
        T = _touched_rows(sl)
        (ff, fb), _ = _sc_work(B, n, N_t, K, R, T)
        b_ms, b_by = bound(ff, fb)
        got_t, src = timed({
            'kernel': lambda: sparse_consensus_fwd(args[0], args[1], sl,
                                                   *args[2:]),
            'plain': lambda: plain_fused_candidate_delta(
                args[0], args[1], sl, *args[2:])})
        log(f'sparse_consensus_kernel: serve shape [1, {n}, {K}, {R}] over '
            f'{N_t} targets ({T} touched): within tolerance (max |err| '
            f'{err:.3g}), a repeat bit-identical; bound '
            f'{b_ms:.5f} ms ({b_by}); ms per call [{src}] / per-call wall ms '
            f'(CUDA events, median of 10): '
            + ', '.join(f'{k} {v[0]:.4f} / {v[1]:.4f}'
                        for k, v in got_t.items()))
        serve_res[n].update(
            name=f'sparse_consensus_fwd@{n}x{N_t}', route='cuda',
            source='dgmc_tpu_torch/csrc/sparse_consensus.cu',
            replaces='dgmc_tpu/ops/pallas/sparse_consensus.py:62',
            max_abs_err=err, ms=got_t['kernel'][0],
            plain_ms=got_t['plain'][0], bound_ms=b_ms, bound_by=b_by,
            library_ms=None, ms_source=src)
    bwd_res.update(name='sparse_consensus_bwd', route='cuda',
                   source='dgmc_tpu_torch/csrc/sparse_consensus.cu',
                   replaces='dgmc_tpu/ops/pallas/sparse_consensus.py:77',
                   max_abs_err=err_b, library_ms=None)

    # The gather-gradient repair: a duplicate-heavy gather, its gradient
    # twice through the port's sorted segment sum and through
    # torch.gather's own backward (float atomics), informational.
    x = torch.randn(1, 2000, 32, generator=gen).cuda().requires_grad_()
    idx = torch.randint(0, 50, (1, 300000), generator=gen).cuda()
    cot = torch.randn(1, 300000, 32, generator=gen).cuda()

    def grad_of(fn):
        x.grad = None
        fn().backward(cot)
        return x.grad.clone()

    ours = [grad_of(lambda: gather_nodes(x, idx)) for _ in range(3)]
    if not all(torch.equal(ours[0], o) for o in ours[1:]):
        raise AssertionError('gather_nodes: its gradient differs on repeats')
    native = [grad_of(lambda: torch.gather(
        x, 1, idx[..., None].expand(-1, -1, 32))) for _ in range(3)]
    diff = [int((native[0] != n).sum()) for n in native[1:]]
    log(f'sparse_consensus_kernel: gather gradient over 300000 rows into 50 '
        f'of 2000 nodes: gather_nodes bit-identical on 3 repeats; '
        f'torch.gather\'s own backward differed from its first run in '
        f'{diff} of {native[0].numel()} entries')


BF16 = torch.bfloat16
#: The bf16 variants' entries in the kernels line: result key -> (source,
#: the TPU kernel's line). Their launches are the bf16 training phases'.
BF16_ROWS = {
    'topk_bf16': ('topk.cu', 'topk.py:40'),
    'spline_route_fwd_bf16': ('spline.cu', 'spline.py:72'),
    'spline_route_bwd_bf16': ('spline.cu', 'spline.py:96'),
    'spline_route_fwd_bf16@64': ('spline.cu', 'spline.py:72'),
    'spline_route_bwd_bf16@64': ('spline.cu', 'spline.py:96'),
    'consensus_fwd_bf16': ('consensus.cu', 'consensus.py:49'),
    'sparse_consensus_fwd_bf16': ('sparse_consensus.cu',
                                  'sparse_consensus.py:62'),
    'sparse_consensus_bwd_bf16': ('sparse_consensus.cu',
                                  'sparse_consensus.py:77')}


#: The draw kernel's rows: ``(main path, kind, [steps, B, N_s, R or
#: num_rnd])`` at the main paths' shapes; each row's launches are its own
#: path's (the whole-graph serve query draws the KG noise's shape too,
#: filed under ``serve``).
RNG_ROWS = {'rng': ('kg_train', 'normal', (10, 1, 15000, 32)),
            'rng@dense': ('train', 'normal', (10, 64, 80, 64)),
            'rng_negatives': ('kg_train', 'negatives', (1, 15000, 10))}
#: ``{(path, kind, steps, B, P): launches}`` of the draw kernel on the
#: float32 main paths (``serve``, ``train``, ``kg_train``), each read
#: around its own run.
RNG_MAIN = {}


class Tally:
    """Launches filed by a key the kernel wrappers do not know (a draw's
    shape, a spline kernel's width): a stand-in counter per key,
    registered with the dispatch ledger (``tally <label> <n>: <key>``), so
    that a captured step's replays add to it as they add to the wrappers'
    own counters, and a capture's warm-up sets it back as it sets them
    back (``dispatch.add_launches``, ``set_launch_counts``). Each tally's
    counters are its own (``n`` numbers them)."""

    ids = itertools.count()

    def __init__(self, label):
        self.prefix = f'tally {label} {next(self.ids)}: '
        self.counters = {}

    def add(self, key, n):
        from dgmc_tpu_torch.ops.kernels import dispatch
        if not n:
            return
        c = self.counters.get(key)
        if c is None:
            c = self.counters[key] = dispatch.kernel_wrapper(
                self.prefix + repr(key))(types.SimpleNamespace())
        c.launches += n

    def counts(self):
        return {k: c.launches for k, c in self.counters.items()}


@contextlib.contextmanager
def rng_launches(path):
    """Within the block, file every launch of the draw kernel under
    ``(path, kind, steps, B, P)`` in :data:`RNG_MAIN`: the wrapper's
    counter (``rng._draw.launches``) read around each call of the model's
    two entry points, ``philox_normal`` and ``philox_negatives``, into a
    :class:`Tally` (so the replays of a captured step count too), added to
    :data:`RNG_MAIN` at the end of the block."""
    from dgmc_tpu_torch.ops.kernels import rng
    normal, negatives = rng.philox_normal, rng.philox_negatives
    tally = Tally(path)

    def counted(key, fn, *args, **kw):
        before = rng._draw.launches
        out = fn(*args, **kw)
        tally.add(key, rng._draw.launches - before)
        return out

    rng.philox_normal = lambda steps, B, P, *a, **kw: counted(
        (path, 'normal', steps, B, P), normal, steps, B, P, *a, **kw)
    rng.philox_negatives = lambda n_valid, P, *a, **kw: counted(
        (path, 'negatives', 1, n_valid.shape[0], P), negatives, n_valid, P,
        *a, **kw)
    try:
        yield
    finally:
        rng.philox_normal, rng.philox_negatives = normal, negatives
        for key, n in tally.counts().items():
            RNG_MAIN[key] = RNG_MAIN.get(key, 0) + n


def _rng_key(path, kind, shape):
    steps, B, N, R = (shape if kind == 'normal' else (1, *shape))
    return path, kind, steps, B, N * R


def _ulps(got, want):
    """Float32 ulps between two tensors of finite values (their bit
    patterns as integers, the same sign assumed where they differ)."""
    return (got.view(torch.int32).long() - want.view(torch.int32).long()).abs()


def phase_rng_kernel(res):
    """The draw kernel (``csrc/rng.cu``) against its plain version on the
    CPU, the device the stream must not depend on: uniforms and negatives
    bit-equal, normals bit-equal or within one float32 ulp (the count of
    elements that differ at all printed), at the main path's shapes (the
    dense noise [10, 64, 80, 64], the KG and whole-graph serve noise [10,
    1, 15000, 32], the small serve queries' [10, 1, 16-64, 32], the
    negatives [1, 15000, 10] over 20000 valid targets) and on ragged
    cases; repeats bit-identical; a batch of pairs equal to the same pairs
    drawn one at a time at their offsets, on the card. Times the kernel,
    its plain version on the card and ``torch.randn`` / ``torch.randint``
    at the same shape (yardstick only), each with its bound (the bytes
    written)."""
    from dgmc_tpu_torch.models.dgmc import draw_negatives, draw_noise
    from dgmc_tpu_torch.ops.kernels import rng
    seed = (7 << 40) + 12345          # both key words in use
    cases = [('dense', (10, 64, 80, 64)), ('kg', (10, 1, 15000, 32)),
             *((f'serve {n}', (10, 1, n, 32)) for n in SMALL_ROWS),
             ('ragged', (3, 2, 7, 3)), ('one', (1, 1, 1, 1))]
    for label, (T, B, N, R) in cases:
        got = draw_noise(T, B, N, R, seed, pair_offset=5, device='cuda')
        torch.cuda.synchronize()
        want = draw_noise(T, B, N, R, seed, pair_offset=5)
        ulps = _ulps(got.cpu(), want)
        n_diff, worst = int((ulps > 0).sum()), int(ulps.max())
        if worst > 1 or not torch.isfinite(got).all():
            raise AssertionError(f'rng normals {label}: {n_diff} elements '
                                 f'differ, by up to {worst} ulps')
        if not torch.equal(got, draw_noise(T, B, N, R, seed, pair_offset=5,
                                           device='cuda')):
            raise AssertionError(f'rng normals {label}: a repeat differs')
        log(f'rng_kernel: normals {label} [{T}, {B}, {N}, {R}]: {n_diff} of '
            f'{got.numel()} elements differ from the CPU plain version '
            f'(at most {worst} float32 ulp); mean {float(got.mean()):.5f}, '
            f'std {float(got.std(correction=0)):.5f}')
        for key, (_, kind, shape) in RNG_ROWS.items():
            if kind == 'normal' and shape == (T, B, N, R):
                res[key]['max_abs_err'] = float(
                    (got.cpu() - want).abs().max())
    # The uniforms' 24 bits exactly: negatives over n_valid = 2^24.
    for label, (B, P) in (('kg', (1, 4800000)), ('ragged', (3, 9))):
        nv = torch.full((B,), 1 << 24)
        got = hold_equal(f'rng uniforms {label}', lambda: rng.philox_negatives(
            nv.cuda(), P, seed, 2, 1).cpu(), lambda: rng.philox_negatives(
                nv, P, seed, 2, 1))
        if not torch.equal(got, rng.plain_philox_words(1, B, P, seed, 2,
                                                       1)[:, :P] >> 8):
            raise AssertionError(f'rng uniforms {label}: not the words\' '
                                 f'24 bits')
        log(f'rng_kernel: uniforms {label} [{B}, {P}] (negatives over 2^24 '
            f'targets): bit-equal to x >> 8')
    for label, n_valid, N, J in (('kg', [20000], 15000, 10),
                                 ('ragged', [20000, 5, 0, 1], 37, 3)):
        nv = torch.tensor(n_valid)
        got = hold_equal(f'rng negatives {label}', lambda: draw_negatives(
            nv.cuda(), N, J, seed, 9).cpu(), lambda: draw_negatives(
                nv, N, J, seed, 9))
        hi = (nv - 1).clamp(min=0)[:, None, None]
        if got.dtype != torch.int64 or (got < 0).any() or (got > hi).any():
            raise AssertionError(f'rng negatives {label}: out of range')
        log(f'rng_kernel: negatives {label} over {n_valid} valid targets '
            f'[{len(n_valid)}, {N}, {J}]: bit-equal, in range')
    res['rng_negatives']['max_abs_err'] = 0.0
    # A batch of pairs draws what the same pairs draw one at a time.
    z = draw_noise(4, 5, 33, 8, seed, pair_offset=3, device='cuda')
    nv = torch.tensor([50, 7, 1, 0, 3], device='cuda')
    neg = draw_negatives(nv, 33, 5, seed, pair_offset=3)
    for b in range(5):
        if not (torch.equal(z[:, b:b + 1], draw_noise(
                4, 1, 33, 8, seed, pair_offset=3 + b, device='cuda'))
                and torch.equal(neg[b:b + 1], draw_negatives(
                    nv[b:b + 1], 33, 5, seed, pair_offset=3 + b))):
            raise AssertionError(f'rng: pair {b} of a batch differs from its '
                                 f'draw alone')
    log('rng_kernel: a batch of 5 pairs at offset 3 equals each pair drawn '
        'alone at its offset (noise and negatives)')
    # A seed tensor (a captured step's seed, read on the card) against
    # the int seed of the same key (written into a tensor by a fill):
    # the same stream, bit for bit, keys at and past 2^63 too.
    for key in (seed, (1 << 63) + 17, (1 << 64) - 1):
        dev_key = rng.seed_tensor(key, 'cuda')
        for label, fn in (
                ('noise', lambda k: draw_noise(10, 1, 15000, 32, k,
                                               device='cuda')),
                ('negatives', lambda k: draw_negatives(
                    torch.tensor([20000], device='cuda'), 15000, 10, k))):
            if not torch.equal(fn(key), fn(dev_key)):
                raise AssertionError(f'rng {label}: the key {key:#x} as a '
                                     f'seed tensor draws another stream than '
                                     f'as an int')
    log('rng_kernel: a seed tensor draws the stream of the int seed of the '
        'same key, bit for bit (noise and negatives at the KG shapes, keys '
        '7 << 40 + 12345, 2^63 + 17 and 2^64 - 1)')

    # Timed with the key already on the card, as a captured step holds it.
    dev_seed = rng.seed_tensor(seed, 'cuda')
    for key, (path, kind, shape) in RNG_ROWS.items():
        _, _, steps, B, P = _rng_key(path, kind, shape)
        if kind == 'normal':
            calls = {'kernel': lambda: rng.philox_normal(
                         steps, B, P, dev_seed, 0, 0, 'cuda'),
                     'plain': lambda: rng.plain_philox_normal(
                         steps, B, P, dev_seed, 0, 0, 'cuda'),
                     'library': lambda: torch.randn(shape, device='cuda')}
            nbytes = rng.draw_work(kind, steps, B, P)['bytes']
        else:
            nv = torch.tensor([20000], device='cuda')
            calls = {'kernel': lambda: rng.philox_negatives(nv, P, dev_seed),
                     'plain': lambda: rng.plain_philox_negatives(
                         nv, P, dev_seed),
                     'library': lambda: torch.randint(
                         0, 20000, shape, device='cuda')}
            nbytes = rng.draw_work(kind, steps, B, P)['bytes']
        got, src = timed(calls)
        b_ms, b_by = bound(0.0, nbytes)
        log(f'rng_kernel: {kind} {list(shape)}: bound {b_ms:.4f} ms '
            f'({nbytes / 1e6:.2f} MB written at {PEAK_BYTES / 1e12} TB/s; the '
            f'float64 and integer operations are not bounded: the peak '
            f'table has no rate for them); ms per call [{src}] / wall: '
            + ', '.join(f'{k} {v[0]:.4f} / {v[1]:.4f}'
                        for k, v in got.items())
            + f'; kernel at {nbytes / got["kernel"][0] / 1e9:.3f} TB/s')
        res[key].update(name=f'rng_{kind}@{"x".join(map(str, shape))}',
                        route='cuda', source='dgmc_tpu_torch/csrc/rng.cu',
                        replaces=('dgmc_tpu/models/dgmc.py:525'
                                  if kind == 'normal'
                                  else 'dgmc_tpu/models/dgmc.py:736'),
                        ms=got['kernel'][0], plain_ms=got['plain'][0],
                        bound_ms=b_ms, bound_by=b_by,
                        library_ms=got['library'][0], ms_source=src)


def _bf16_row(res, key, **kw):
    source, line = BF16_ROWS[key]
    name = key.replace('@64', '@O=64')
    res[key].update(name=name, route='cuda',
                    source=f'dgmc_tpu_torch/csrc/{source}',
                    replaces=f'dgmc_tpu/ops/pallas/{line}', **kw)


def phase_bf16_kernels(res):
    """Each kernel's bf16 variant (the precision policy's) against its
    plain bf16 version on the card: bit-equal on exact inputs; on
    continuous inputs at the main path's shapes a bf16 output within one
    bf16 ulp (:func:`hold_ulp`), a float32 one within rtol 1e-5 / atol
    1e-5 x max|out| (:func:`hold_close`), and top-k's picks by
    :func:`hold_bf16_topk`. Times each beside its float32 variant on
    the same values (informational) and, for the JSON line, beside its
    plain version and the PyTorch call in bf16 where there is one, with
    its bound in bf16 bytes and operations at the bf16 peak."""
    from dgmc_tpu_torch.models.spline import spline_routing
    from dgmc_tpu_torch.ops.graph import GraphBatch
    from dgmc_tpu_torch.experiments import pascal_pf
    from dgmc_tpu_torch.ops.kernels import dispatch
    from dgmc_tpu_torch.ops.kernels.consensus import (consensus_fwd,
                                                      plain_consensus)
    from dgmc_tpu_torch.ops.kernels.sparse_consensus import (
        plain_sparse_consensus_bwd, plain_sparse_consensus_fwd,
        sparse_consensus_bwd, sparse_consensus_fwd)
    from dgmc_tpu_torch.ops.kernels.spline import (plain_route_aggregate,
                                                   plain_route_d_t,
                                                   route_d_t, route_fwd)
    from dgmc_tpu_torch.ops.kernels import topk as topk_kernels
    from dgmc_tpu_torch.ops.kernels.topk import (K_MAX, plain_topk,
                                                 streaming_topk)
    gen = torch.Generator().manual_seed(7)

    def b16(*xs):
        return [x.to(BF16) for x in xs]

    def dtype_of(name):
        return dispatch.decisions()[name]['dtype']

    # -- top-k: each case with the route the wrapper must record (the
    # tensor-core tile, or the FMA kernel for a shape the tile does not
    # take).
    TC, C8, KBIG, CBIG = ('tensor-core', 'fma, C%8!=0', 'fma, k>16',
                          'fma, C>640')
    masked_block = _topk_case(gen, 2, 300, 1000, 64, 10)
    mask = torch.ones(2, 1000, dtype=torch.bool, device='cuda')
    mask[0] = False                  # batch 0: every target masked
    mask[1, 128:384] = False         # batch 1: two whole target tiles
    masked_block = (*masked_block[:3], mask)
    for name, want, (h_s, h_t, k, mask) in (
            ('ties_mask', TC, _topk_case(gen, 2, 300, 700, 8, 7,
                                         mask_p=0.3)),
            ('k_above_valid', C8, _topk_case(gen, 1, 40, 20, 4, 9, valid=5)),
            ('k_above_valid_c8', TC, _topk_case(gen, 1, 40, 20, 8, 9,
                                                valid=5)),
            ('batch_2', TC, _topk_case(gen, 2, 130, 1100, 16, 10,
                                       mask_p=0.5)),
            ('k_max', KBIG, _topk_case(gen, 1, 200, 3000, 32, K_MAX,
                                       mask_p=0.9)),
            ('rows_17x20000_masked', TC, _topk_case(gen, 1, 17, 20000, 32,
                                                    10, mask_p=0.5)),
            # The tensor-core tile's edges: rows no multiple of 64 or 128,
            # targets no multiple of a tile, a ragged last k16 slice of
            # channels (C = 200, 264), k = 1 and 16, whole masked blocks.
            ('rows_200', TC, _topk_case(gen, 1, 200, 1024, 64, 10)),
            ('targets_1000', TC, _topk_case(gen, 1, 128, 1000, 64, 10)),
            ('c200', TC, _topk_case(gen, 1, 300, 1000, 200, 10,
                                    mask_p=0.3)),
            ('c264', TC, _topk_case(gen, 1, 257, 700, 264, 10)),
            ('k1', TC, _topk_case(gen, 1, 200, 3000, 64, 1)),
            ('k16', TC, _topk_case(gen, 2, 130, 1100, 256, 16,
                                   mask_p=0.5)),
            ('masked_blocks', TC, masked_block),
            ('c648', CBIG, _topk_case(gen, 1, 130, 500, 648, 10)),
            ('c256_ties_mask', TC, _topk_case(gen, 1, 300, 2000, 256, 10,
                                              mask_p=0.3)),
            ('c256_rows_17x20000', TC, _topk_case(gen, 1, 17, 20000, 256,
                                                  10)),
            ('c256_k_max', KBIG, _topk_case(gen, 2, 130, 1100, 256, K_MAX,
                                            mask_p=0.5)),
            ('main_shape', TC, _topk_case(gen, *TOPK_SHAPE))):
        h_s, h_t = b16(h_s, h_t)
        v, i = streaming_topk(h_s, h_t, k, mask)
        torch.cuda.synchronize()
        pv, pi = plain_topk(h_s, h_t, k, mask)
        d = dispatch.decisions()['topk']
        if (d['dtype'] != 'bfloat16' or d['path'] != 'kernel'
                or d['reason'] != want):
            raise AssertionError(f'topk bf16 case {name}: dispatch {d}, '
                                 f'expected the route {want!r}')
        if not (torch.equal(i, pi) and torch.equal(v, pv)):
            raise AssertionError(f'topk bf16 case {name}: kernel differs '
                                 f'from the plain version in '
                                 f'{int((i != pi).any(-1).sum())} rows')
        log(f'bf16_kernels: topk case {name} {tuple(h_s.shape)}x'
            f'{tuple(h_t.shape)} k={k} ({want}): bit-equal')
    B, N_s, N_t, C, k = TOPK_SHAPE
    h_s, h_t, _, _ = _topk_case(gen, B, N_s, N_t, C, k, ints=False)
    h_s, h_t = b16(h_s, h_t)
    h_s32, h_t32 = h_s.float(), h_t.float()   # the same values in float32
    err = hold_bf16_topk('random', h_s, h_t, k)
    if dispatch.decisions()['topk']['reason'] != TC:
        raise AssertionError('topk bf16 at the main shape: not the '
                             'tensor-core route')
    # One call, the same values: the tensor-core tile, the bf16 FMA entry
    # (the route before it), the float32 kernel, torch.topk(bmm) in bf16,
    # the plain version.
    ms = cuda_ms(lambda: streaming_topk(h_s, h_t, k))
    fma_ms = cuda_ms(lambda: topk_kernels._launch('bf16_fma', h_s, h_t, k))
    ms32 = cuda_ms(lambda: streaming_topk(h_s32, h_t32, k))
    plain_ms = cuda_ms(lambda: plain_topk(h_s, h_t, k), runs=3)
    lib_ms = cuda_ms(lambda: torch.topk(torch.bmm(h_s, h_t.transpose(1, 2)),
                                        k))
    b_ms, b_by = work_bound(topk_work(B, N_s, N_t, C, k, 2),
                            PEAK_BF16_FLOPS)
    log(f'bf16_kernels: topk at {N_s}x{N_t} C={C} k={k} on random inputs '
        f'(held above); CUDA events, median of 10: tensor-core kernel '
        f'{ms:.3f} ms ({2.0 * B * N_s * N_t * C / ms / 1e9:.1f} TFLOP/s, '
        f'{100 * b_ms / ms:.1f}% of the bound), bf16 FMA entry '
        f'{fma_ms:.3f} ms, float32 kernel {ms32:.3f} ms (the same values), '
        f'torch.topk(bmm) bf16 {lib_ms:.3f} ms, plain bf16 {plain_ms:.3f} '
        f'ms (median of 3); bound {b_ms:.4f} ms ({b_by}, bf16 peak)')
    _bf16_row(res, 'topk_bf16', max_abs_err=err, ms=ms, plain_ms=plain_ms,
              bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
              ms_source='cuda_events')
    del h_s, h_t, h_s32, h_t32
    torch.cuda.empty_cache()

    # -- SplineConv routing
    for name, shape in (('masked', (2, 11, 40, 16, 0.3)),
                        ('train_width', (4, 80, 640, 64, 0.0)),
                        ('o_256', (2, 80, 640, 256, 0.2))):
        t, g, basis, routing = _spline_exact(gen, *shape)
        t, g = b16(t, g)
        hold_equal(f'spline fwd bf16 {name}',
                   lambda: route_fwd(t, basis, routing),
                   lambda: plain_route_aggregate(t, basis, routing))
        hold_equal(f'spline d_t bf16 {name}',
                   lambda: route_d_t(g, basis, routing),
                   lambda: plain_route_d_t(g, basis, routing))
        if dtype_of('spline_route_bwd') != 'bfloat16':
            raise AssertionError('spline: the bf16 variant did not run')
        log(f'bf16_kernels: spline case {name}: fwd and d_t bit-equal, '
            f'repeats identical')
    args = _train_args()
    _, loader, _ = pascal_pf.build(args)
    graph = GraphBatch.from_numpy(next(iter(loader)).s, 'cuda')
    basis, routing = spline_routing(graph, 5)
    B, N = graph.x.shape[:2]
    M = routing.num_rows
    for O, tag in ((args.dim, ''), (args.rnd_dim, '@64')):
        t, g = b16(torch.randn(B, M, O, generator=gen).cuda(),
                   torch.randn(B, N, O, generator=gen).cuda())
        t32, g32 = t.float(), g.float()
        err_f = hold_ulp(f'spline fwd bf16 O={O}', route_fwd(t, basis,
                                                             routing),
                         plain_route_aggregate(t, basis, routing))
        err_b = hold_ulp(f'spline d_t bf16 O={O}', route_d_t(g, basis,
                                                             routing),
                         plain_route_d_t(g, basis, routing))
        (fb, fby), (bb, bby) = _spline_work(basis, routing, O, 2,
                                            PEAK_BF16_FLOPS)
        calls = {'fwd': lambda: route_fwd(t, basis, routing),
                 'fwd f32': lambda: route_fwd(t32, basis, routing),
                 'fwd plain': lambda: plain_route_aggregate(t, basis,
                                                            routing),
                 'd_t': lambda: route_d_t(g, basis, routing),
                 'd_t f32': lambda: route_d_t(g32, basis, routing),
                 'd_t plain': lambda: plain_route_d_t(g, basis, routing)}
        try:   # the yardstick in bf16, where cuSPARSE takes it
            R = _routing_matrix(basis, routing).to(BF16)
            RT = _routing_matrix(basis, routing, transpose=True).to(BF16)
            t2, g2 = t.reshape(B * M, O), g.reshape(B * N, O)
            torch.sparse.mm(R, t2), torch.sparse.mm(RT, g2)
            calls.update({'fwd sparse.mm': lambda: torch.sparse.mm(R, t2),
                          'd_t sparse.mm': lambda: torch.sparse.mm(RT, g2)})
        except RuntimeError as e:
            log(f'bf16_kernels: torch.sparse.mm in bf16 not available: '
                f'{str(e)[:120]}')
        got, src = timed(calls)
        log(f'bf16_kernels: spline O={O} [{B}, {M}, {O}] on a '
            f'RandomGraphPairs batch: bf16 within an ulp of plain (max |err| '
            f'fwd {err_f:.3g}, d_t {err_b:.3g}); bound fwd {fb:.4f} ms '
            f'({fby}), d_t {bb:.4f} ms ({bby}); ms per call [{src}] / '
            f'per-call wall ms (CUDA events, median of 10): '
            + ', '.join(f'{k} {v[0]:.4f} / {v[1]:.4f}'
                        for k, v in got.items()))
        lib = {key: got[key][0] if key in got else None
               for key in ('fwd sparse.mm', 'd_t sparse.mm')}
        _bf16_row(res, f'spline_route_fwd_bf16{tag}', max_abs_err=err_f,
                  ms=got['fwd'][0], plain_ms=got['fwd plain'][0],
                  bound_ms=fb, bound_by=fby, library_ms=lib['fwd sparse.mm'],
                  ms_source=src)
        _bf16_row(res, f'spline_route_bwd_bf16{tag}', max_abs_err=err_b,
                  ms=got['d_t'][0], plain_ms=got['d_t plain'][0],
                  bound_ms=bb, bound_by=bby, library_ms=lib['d_t sparse.mm'],
                  ms_source=src)

    # -- dense consensus
    def cons_case(B, N_s, N_t, R, ints):
        def draw(*shape, scale=1.0):
            if ints:
                return torch.randint(-2, 3, shape, generator=gen).float()
            return scale * torch.randn(*shape, generator=gen)
        return [x.cuda() for x in (
            draw(B, N_s, R), draw(B, N_t, R), draw(R, R, scale=R ** -0.5),
            draw(R, scale=0.1), draw(R, 1, scale=R ** -0.5),
            draw(1, scale=0.1))]

    for name, shape in (('ragged', (2, 20, 37, 8)), ('r_33', (3, 80, 80, 33)),
                        ('train_width', (64, 80, 80, 64)),
                        ('r_max', (2, 33, 65, 128))):
        a = b16(*cons_case(*shape, ints=True))
        hold_equal(f'consensus bf16 {name}', lambda: consensus_fwd(*a),
                   lambda: plain_consensus(*a))
        if dtype_of('consensus_fwd') != 'bfloat16':
            raise AssertionError('consensus: the bf16 variant did not run')
        log(f'bf16_kernels: consensus case {name}: bit-equal, repeat '
            f'identical')
    B, N_s, N_t, R = 64, 80, 80, 64
    a = b16(*cons_case(B, N_s, N_t, R, ints=False))
    a32 = [x.float() for x in a]
    err = hold_close('consensus bf16 train_width', consensus_fwd(*a),
                     plain_consensus(*a))
    got, src = timed({'kernel': lambda: consensus_fwd(*a),
                      'kernel f32': lambda: consensus_fwd(*a32),
                      'plain': lambda: plain_consensus(*a)})
    b_ms, b_by = work_bound(consensus_work(B, N_s, N_t, R, 2),
                            PEAK_BF16_FLOPS)
    log(f'bf16_kernels: consensus at [{B}, {N_s}, {N_t}] R={R}: float32 '
        f'output within tolerance (max |err| {err:.3g}); bound {b_ms:.4f} '
        f'ms ({b_by}); ms per call [{src}] / per-call wall ms (CUDA events, '
        f'median of 10): ' + ', '.join(f'{k} {v[0]:.4f} / {v[1]:.4f}'
                                       for k, v in got.items())
        + f'; by launch: {fmt_split(launch_split(lambda: consensus_fwd(*a)))}')
    _bf16_row(res, 'consensus_fwd_bf16', max_abs_err=err,
              ms=got['kernel'][0], plain_ms=got['plain'][0], bound_ms=b_ms,
              bound_by=b_by, library_ms=None, ms_source=src)

    # -- sparse consensus, forward (with its state, as training calls it)
    # and backward
    for name, shape in (('duplicates', (2, 1000, 300, 20, 32, 0.9)),
                        ('hub', (1, 15000, 20000, 20, 32, 'hub')),
                        ('k_40_r_33', (2, 300, 500, 40, 33, 0.0)),
                        ('r_128_few_candidates', (2, 50, 3000, 10, 128, 0.0))):
        a, sl, g = _sc_case(gen, *shape)
        a = b16(*a)
        out, state = sparse_consensus_fwd(a[0], a[1], sl, *a[2:],
                                          return_state=True)
        grads = sparse_consensus_bwd(*a[:2], sl, *a[2:5], g, state)
        torch.cuda.synchronize()
        if dtype_of('sparse_consensus_bwd') != 'bfloat16':
            raise AssertionError('sparse consensus: the bf16 variant did '
                                 'not run')
        if not torch.equal(out, plain_sparse_consensus_fwd(a[0], a[1], sl,
                                                           *a[2:])):
            raise AssertionError(f'sparse bf16 {name}: forward differs')
        if not torch.equal(state[2], _sc_plain_mask(a, sl)):
            raise AssertionError(f'sparse bf16 {name}: ReLU mask differs')
        want = plain_sparse_consensus_bwd(*a[:2], sl, *a[2:5], g)
        again = sparse_consensus_bwd(*a[:2], sl, *a[2:5], g, state)
        for label, x, w, y in zip(SC_GRADS, grads, want, again):
            if not (torch.equal(x, w) and torch.equal(x, y)):
                raise AssertionError(f'sparse bf16 {name}: {label} differs')
        log(f'bf16_kernels: sparse consensus case {name}: forward, mask and '
            f'gradients bit-equal, repeat identical')
    B, N_s, N_t, K, R = 1, 15000, 20000, 20, 32
    a, sl, g = _sc_case(gen, B, N_s, N_t, K, R, ints=False)
    a = b16(*a)
    a32 = [x.float() for x in a]
    out, state = sparse_consensus_fwd(a[0], a[1], sl, *a[2:],
                                      return_state=True)
    _, state32 = sparse_consensus_fwd(a32[0], a32[1], sl, *a32[2:],
                                      return_state=True)
    grads = sparse_consensus_bwd(*a[:2], sl, *a[2:5], g, state)
    torch.cuda.synchronize()
    err_f = hold_close('sparse fwd bf16', out, plain_sparse_consensus_fwd(
        a[0], a[1], sl, *a[2:]))
    err_b = max(hold_ulp(f'sparse bwd bf16 {label}', x, w) for label, x, w in
                zip(SC_GRADS, grads, plain_sparse_consensus_bwd(
                    *a[:2], sl, *a[2:5], g)))
    (ff, fbytes), (bf, bbytes) = _sc_work(B, N_s, N_t, K, R, elem=2)
    fb_ms, fb_by = bound(ff, fbytes, PEAK_BF16_FLOPS)
    bb_ms, bb_by = bound(bf, bbytes, PEAK_BF16_FLOPS)
    def fwd():
        return sparse_consensus_fwd(a[0], a[1], sl, *a[2:],
                                    return_state=True)

    def bwd():
        return sparse_consensus_bwd(*a[:2], sl, *a[2:5], g, state)

    got, src = timed({
        'fwd': fwd,
        'fwd f32': lambda: sparse_consensus_fwd(a32[0], a32[1], sl,
                                                *a32[2:], return_state=True),
        'fwd plain': lambda: plain_sparse_consensus_fwd(a[0], a[1], sl,
                                                        *a[2:]),
        'bwd': bwd,
        'bwd f32': lambda: sparse_consensus_bwd(*a32[:2], sl, *a32[2:5], g,
                                                state32),
        'bwd plain': lambda: plain_sparse_consensus_bwd(*a[:2], sl, *a[2:5],
                                                        g)})
    log(f'bf16_kernels: sparse consensus at [{B}, {N_s}, {K}, {R}] over '
        f'{N_t} targets: delta within tolerance (max |err| {err_f:.3g}), '
        f'gradients within an ulp (max |err| {err_b:.3g}); bound fwd '
        f'{fb_ms:.4f} ms ({fb_by}), bwd {bb_ms:.4f} ms ({bb_by}); ms per '
        f'call [{src}] / per-call wall ms (CUDA events, median of 10): '
        + ', '.join(f'{k} {v[0]:.4f} / {v[1]:.4f}' for k, v in got.items()))
    log(f'bf16_kernels: sparse consensus device ms per call by launch: fwd '
        f'{fmt_split(launch_split(fwd))}; bwd {fmt_split(launch_split(bwd))}')
    _bf16_row(res, 'sparse_consensus_fwd_bf16', max_abs_err=err_f,
              ms=got['fwd'][0], plain_ms=got['fwd plain'][0],
              bound_ms=fb_ms, bound_by=fb_by, library_ms=None, ms_source=src)
    _bf16_row(res, 'sparse_consensus_bwd_bf16', max_abs_err=err_b,
              ms=got['bwd'][0], plain_ms=got['bwd plain'][0],
              bound_ms=bb_ms, bound_by=bb_by, library_ms=None, ms_source=src)


def phase_train_bf16(results):
    """The dense training main path under the bf16 policy at the PascalPF
    widths: kernels in bf16 at their launch counts, a finite and falling
    loss; then one step profiled beside its peak memory (informational,
    for the bf16 step against the float32 one of ``train``)."""
    losses, _, _ = _dense_main_path(results, 'bf16')
    if not np.mean(losses[-4:]) < np.mean(losses[:4]):
        raise AssertionError(f'bf16 dense loss did not fall: {losses}')
    _step_profile(dense_step('bf16'), 'one bf16 train step')


def phase_kg_train_bf16(results):
    """The KG training main path under the bf16 policy at the DBP15K
    widths: kernels in bf16 at their launch counts, the top-k on the
    tensor-core route, a finite loss that falls over phase 1; the top-k
    kernel held by :func:`hold_bf16_topk` on the trained model's own
    ψ₁ outputs (as its phase-2 eval step feeds them); then one phase-2
    step profiled beside its peak memory (informational)."""
    from dgmc_tpu_torch.experiments import dbp15k
    from dgmc_tpu_torch.ops.kernels import dispatch
    from dgmc_tpu_torch.ops.kernels.topk import route
    from dgmc_tpu_torch.train.steps import batch_to_device
    losses, _, _, state = _kg_main_path(results, 'bf16')
    d = dispatch.decisions()['topk']
    args = dbp15k.parse_args(KG_ARGV + ['--precision', 'bf16'])
    want = route(BF16, 1, args.syn_nodes_s, args.syn_nodes_t, args.dim,
                 args.k)
    if (d['reason'] != 'tensor-core' or want != ('bf16_tc', 'tensor-core')
            or d['dtypes'] != {'kernel:bfloat16': 19}
            or results['topk_bf16']['launches'] != 19):
        raise AssertionError(f'kg_train (bf16): top-k dispatch {d}, '
                             f'launches {results["topk_bf16"]["launches"]}'
                             f'; expected 19 on the tensor-core route')
    log(f'kg_train (bf16): top-k {d["dtypes"]} on the route '
        f'{d["reason"]!r}')
    if not losses[9] < losses[0]:
        raise AssertionError(f'bf16 KG loss did not fall in phase 1: '
                             f'{losses}')
    # The trained model's ψ₁ outputs, cast as the forward casts them.
    _, test_b, in_dim = dbp15k.synthetic_batches(args)
    model = dbp15k.build(args, in_dim).cuda().eval()
    with torch.no_grad():
        for p, q in zip(model.parameters(),
                        state.optimizer.param_groups[0]['params']):
            p.copy_(q)
        g_s, g_t = batch_to_device(test_b, 'cuda')[:2]
        h_s = model._cast(model.psi_1(g_s.x, g_s))
        h_t = model._cast(model.psi_1(g_t.x, g_t))
    if h_s.dtype != BF16:
        raise AssertionError(f'phase-2 inputs in {h_s.dtype}')
    hold_bf16_topk('trained phase-2 inputs', h_s, h_t, args.k,
                   g_t.node_mask)
    _step_profile(kg_step('bf16'), 'one bf16 phase-2 step')


def _step_profile(run, label):
    """Peak memory of one step after a warm-up one, then its profile and
    the port's kernels in it, each with its launches and time a launch
    (on a KG phase-2 step, the real shortlists) (informational: a profile
    that fails prints 'not measured')."""
    run()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f'{label}: max_memory_allocated over one step {peak} bytes '
        f'({peak / 2**30:.3f} GiB)')
    try:
        rows = profile(run, label, top=12)
        log(f'profile: {label}: the port\'s kernels (ms, launches, ms a '
            f'launch): ' + ', '.join(
                f'{name} {dev_us / 1e3:.4f} ms x{count} = '
                f'{dev_us / 1e3 / count:.4f}'
                for name, dev_us, count in port_kernels(rows)))
    except Exception as e:   # the breakdown is informational only
        log(f'profile: {label}: not measured ({e!r})')


#: Launches per step of the KG training path: (topk, sparse-consensus
#: forward, backward). One search per forward; 10 consensus steps.
KG_KERNELS = ('topk', 'sparse_consensus_fwd', 'sparse_consensus_bwd',
              'blocked', 'rng')
#: ... the blocked aggregation (the CLI's default, 2 a RelConv layer:
#: ψ₁'s 3 layers on both graphs, 12, with as many backward launches in
#: phase 1; in phase 2 ψ₁ detached, the packed ψ₂ on the source, 6, and ψ₂
#: on the target in each of 10 steps, 60, each with its backward) and the
#: draws: the negatives in every training step, the indicator noise
#: wherever consensus steps run.
KG_PER = {('train', 1): (1, 0, 0, 24, 1), ('eval', 1): (1, 0, 0, 12, 0),
          ('train', 2): (1, 10, 10, 144, 2), ('eval', 2): (1, 10, 0, 78, 1)}
KG_ARGV = ['--synthetic', '--seed', '0']
#: Each phase pins its precision policy (the CLIs' default is bf16);
#: ``--precision f32`` is also what the port's trees before the policy
#: accept, so ``--steps`` and ``--kernels`` still time them.
F32_ARGV = ['--precision', 'f32']
#: The CPU comparison's reduced node and edge counts (widths unchanged).
KG_SMALL = ['--syn_nodes_s', '1500', '--syn_nodes_t', '2000',
            '--syn_edges_s', '10000', '--syn_edges_t', '12000']


def _kg_loss_and_grads(model, batch, S_idx, r_s, neg, device, dtype):
    """Loss and gradients of one phase-2 training forward (10 steps, ψ₁
    detached) with the shortlist, noise and negatives given."""
    from dgmc_tpu_torch.models import metrics
    from dgmc_tpu_torch.train.steps import batch_to_device
    model = model.to(device=device, dtype=dtype).train()
    g_s, g_t, y, y_mask = batch_to_device(batch, device)
    g_s.x, g_t.x = g_s.x.to(dtype), g_t.x.to(dtype)
    _, S_L = model(g_s, g_t, y=y, y_mask=y_mask, S_idx=S_idx.to(device),
                   num_steps=10, detach=True, r_s=r_s.to(device, dtype),
                   negatives=neg.to(device))
    loss = metrics.nll_loss(S_L, y, y_mask)
    loss.backward()
    if device == 'cuda':
        torch.cuda.synchronize()
    return loss.item(), {n: p.grad.detach().to('cpu', torch.float64)
                         for n, p in model.named_parameters()
                         if p.grad is not None}


@contextlib.contextmanager
def plain_on_card():
    """Within the block the model's kernels give way to their plain
    versions on the card too (the spline routing, the dense and the
    sparse consensus, each differentiable by autograd; the blocked
    aggregation, whose backward is itself): the card's
    float32 path without the port's kernels, which tells a kernel's
    rounding from that of the card's libraries (cuBLAS, atomics)."""
    from dgmc_tpu_torch.models import dgmc as dgmc_mod
    from dgmc_tpu_torch.models import spline as spline_mod
    from dgmc_tpu_torch.ops import blocked as blocked_ops
    from dgmc_tpu_torch.ops.kernels import blocked, sparse_consensus, spline
    swaps = [(dgmc_mod, 'consensus_update', dgmc_mod.plain_consensus),
             (sparse_consensus, 'fused_candidate_delta',
              sparse_consensus.plain_fused_candidate_delta),
             (spline_mod, 'route_aggregate', spline.plain_route_aggregate),
             (blocked, 'aggregate', blocked_ops.plain_aggregate)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


#: A first step's runs: label, device, dtype, the port's kernels on (on
#: the CPU every wrapper takes its plain version anyway).
FIRST_STEP_RUNS = (('cuda', 'cuda', torch.float32, True),
                   ('cuda plain', 'cuda', torch.float32, False),
                   ('cuda plain float64', 'cuda', torch.float64, False),
                   ('cpu', 'cpu', torch.float32, True),
                   ('cpu float64', 'cpu', torch.float64, True))


#: Threads the CPU's first-step references run in at once, each with its
#: share of the cores (one draw's runs are independent of another's).
CPU_REF_THREADS = 4


def _first_steps(jobs):
    """For each ``(label, run)`` of ``jobs``, ``{run label: (loss,
    grads)}`` of ``run(device, dtype)`` (one training forward and
    backward) for each of :data:`FIRST_STEP_RUNS`. The card's runs go one
    after another (:func:`plain_on_card` swaps module functions while it
    lasts); then the CPU's, each on its own copy of the model, run
    :data:`CPU_REF_THREADS` at a time, the float64 runs (the longer ones)
    first."""
    outs = [{} for _ in jobs]

    def one(out, label, run, name, dev, dtype):
        t0 = time.perf_counter()
        out[name] = run(dev, dtype)
        log(f'{label}: forward+backward on {name}: loss {out[name][0]:.8f} '
            f'in {time.perf_counter() - t0:.2f}s')

    cpu = []
    for out, (label, run) in zip(outs, jobs):
        for name, dev, dtype, kernels in FIRST_STEP_RUNS:
            if dev == 'cpu':
                cpu.append((out, label, run, name, dev, dtype))
                continue
            with contextlib.nullcontext() if kernels else plain_on_card():
                one(out, label, run, name, dev, dtype)
    cpu.sort(key=lambda job: job[5] != torch.float64)    # stable
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads // CPU_REF_THREADS))
    try:
        with concurrent.futures.ThreadPoolExecutor(CPU_REF_THREADS) as pool:
            for f in [pool.submit(one, *job) for job in cpu]:
                f.result()
    finally:
        torch.set_num_threads(threads)
    return outs


def _hold_grads(label, draws):
    """The first step on the card against the CPU plain path over several
    draws of the main path (``draws``: one :func:`_first_steps` each):

    - on every draw the losses within 1e-4 relative (float32) and 1e-10
      (float64), the same parameters with gradients, the
      :data:`ZERO_GRAD` ones ~0;
    - the card computes the CPU's function: in float64, its plain path
      (``cuda plain float64``, :func:`plain_on_card`) gives each
      gradient within GRAD_F64_TOL of the tensor's largest entry from
      the CPU's;
    - each gradient of the kernels' float32 path within GRAD_TOL of its
      largest entry from the CPU's on every draw, or else, held against
      the CPU float64 path (errors as fractions of the tensor's largest
      float64 entry): no larger than GRAD_F64_RATIO x the error of the
      card's own float32 path without the port's kernels (``cuda
      plain``), in the mean over the draws and at the worst draw.

    At random init ψ₂'s gradients are small sums of large terms that
    cancel, so float32 rounding alone moves them by 1e-3 to 1e-2 of their
    largest entry, by different amounts on each draw and on each device:
    the float32 runs differ by up to 12x on one draw, each way, and on
    some draws all three err by the same amount. The card's plain path
    shares every library call of the card's run but none of the port's
    kernels: what the kernels' error is held against. The CPU float32
    error is printed beside it."""
    for i, out in enumerate(draws):
        for card, cpu, tol in (('cuda', 'cpu', 1e-4),
                               ('cuda plain float64', 'cpu float64', 1e-10)):
            rel = abs(out[card][0] - out[cpu][0]) / abs(out[cpu][0])
            if rel > tol:
                raise AssertionError(f'{label} draw {i}: {card} and {cpu} '
                                     f'losses differ: {rel}')
        for name, ref in out['cpu float64'][1].items():
            got = out['cuda plain float64'][1][name]
            scale = max(float(ref.abs().max()), 1e-30)
            err = float((got - ref).abs().max()) / scale
            if name not in ZERO_GRAD and err > GRAD_F64_TOL:
                raise AssertionError(f'{label} draw {i} {name}: the card\'s '
                                     f'float64 gradient differs from the '
                                     f'CPU\'s by {err:.3g} of max|grad|')
        if set(out['cuda'][1]) != set(out['cpu'][1]):
            raise AssertionError(f'{label} draw {i}: CPU and CUDA differ in '
                                 f'which parameters have gradients')
        for name in ZERO_GRAD:
            got = [out[k][1][name] for k in ('cuda', 'cpu')
                   if name in out[k][1]]
            if any(float(g.abs().max()) > 1e-5 for g in got):
                raise AssertionError(f'{label} draw {i} {name}: gradient '
                                     f'not ~0')
    worst, by_f64 = 0.0, []
    for name in draws[0]['cpu float64'][1]:
        if name in ZERO_GRAD:
            continue
        diff, errs = [], {k: [] for k in ('cuda', 'cuda plain', 'cpu')}
        for out in draws:
            ref = out['cpu float64'][1][name]
            scale = float(ref.abs().max())
            diff.append(float((out['cuda'][1][name]
                               - out['cpu'][1][name]).abs().max()) / scale)
            for k, e in errs.items():
                e.append(float((out[k][1][name] - ref).abs().max()) / scale)
        worst = max(worst, max(diff))
        if max(diff) <= GRAD_TOL:
            continue
        mean = {k: statistics.mean(e) for k, e in errs.items()}
        top = {k: max(e) for k, e in errs.items()}
        by_f64.append(name)
        log(f'{label}: {name} against float64 over {len(draws)} draws (of '
            f'max|grad|): ' + '; '.join(
                f'{k} mean {mean[k]:.3g} worst {top[k]:.3g} ['
                + ', '.join(f'{x:.3g}' for x in e) + ']'
                for k, e in errs.items()))
        for stat, v in (('mean', mean), ('worst draw', top)):
            if v['cuda'] > GRAD_F64_RATIO * v['cuda plain']:
                raise AssertionError(
                    f'{label} {name}: the CUDA gradient\'s error against '
                    f'float64 ({stat} {v["cuda"]:.3g}) exceeds '
                    f'{GRAD_F64_RATIO:g} x that of the card\'s path '
                    f'without the port\'s kernels ({v["cuda plain"]:.3g})')
    log(f'{label}: CUDA agrees with the CPU plain path on {len(draws)} '
        f'draws: in float64 every gradient within {GRAD_F64_TOL:g} x '
        f'max|grad|; in float32 {len(draws[0]["cuda"][1])} gradients within '
        f'{GRAD_TOL:g} x max|grad| per tensor (worst {worst:.3g}) except, '
        f'held against float64: {by_f64 or "none"}')


def _kg_main_path(results, policy):
    """The KG training main path through ``dbp15k.main`` under ``policy``
    (10 phase-1 epochs, one eval, then 4 phase-2 epochs with their evals)
    at the DBP15K widths: the counters set to 0 just before and read just
    after, the launches per step, the dispatch ledger (kernel, in the
    policy's dtype), finite losses. Files the launches under the kernels'
    names (``_bf16`` appended under bf16) and returns ``(losses, peak
    bytes, phase-1 / phase-2 step ms, the trained state)``."""
    from dgmc_tpu_torch.experiments import dbp15k
    from dgmc_tpu_torch.ops.kernels import dispatch
    dtype = 'bfloat16' if policy == 'bf16' else 'float32'
    tag = '_bf16' if policy == 'bf16' else ''
    marks, losses = [], []

    def hook(kind, epoch, out):
        torch.cuda.synchronize()
        marks.append((kind, epoch, time.perf_counter(),
                      dispatch.launch_counts()))
        if kind == 'train':
            losses.append(float(out['loss']))

    P1, EPOCHS = 10, 14
    argv = ['--synthetic', '--seed', '0', '--precision', policy, '--epochs',
            str(EPOCHS), '--phase1_epochs', str(P1)]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # The main path: counters at 0 just before, read just after.
    with (rng_launches('kg_train') if policy == 'f32'
          else contextlib.nullcontext()), blocked_launches(
              'kg_train' + tag):
        dispatch.reset()
        marks.append(('start', 0, t0, dispatch.launch_counts()))
        state = dbp15k.main(argv, hook=hook)
        counts = dispatch.launch_counts()
    decisions = dispatch.decisions()
    peak = torch.cuda.max_memory_allocated()
    want_kinds = ([('train', e) for e in range(1, P1 + 1)] + [('eval', P1)]
                  + [(k, e) for e in range(P1 + 1, EPOCHS + 1)
                     for k in ('train', 'eval')])
    if [m[:2] for m in marks[1:]] != want_kinds:
        raise AssertionError(f'unexpected step sequence '
                             f'{[m[:2] for m in marks[1:]]}')
    for prev, cur in zip(marks, marks[1:]):
        want = KG_PER[(cur[0], 1 if cur[1] <= P1 else 2)]
        got = tuple(cur[3][k] - prev[3][k] for k in KG_KERNELS)
        if got != want:
            raise AssertionError(f'{cur[0]} at epoch {cur[1]}: launches '
                                 f'{got}, expected {want}')
    for name in KG_KERNELS:
        d = decisions[name]
        # The draws: float32 noise, int64 negatives.
        # The blocked kernel's rows: ψ₂'s 32-wide bf16 ones are widened to
        # float32.
        want = ({'kernel:float32', 'kernel:int64'} if name == 'rng'
                else {'kernel:float32', 'kernel:bfloat16'}
                if name == 'blocked' and policy == 'bf16'
                else {f'kernel:{dtype}'})
        if (d['path'] != 'kernel' or d['counts']['plain']
                or set(d['dtypes']) != want):
            raise AssertionError(f'{name}: dispatch {d}')
    for name in KG_KERNELS[1 if policy == 'f32' else 0:-2]:
        results[name + tag]['launches'] = counts[name]
    _hold_native_collation(f'kg_train ({policy})', decisions)
    if not np.isfinite(losses).all():
        raise AssertionError(f'non-finite train loss: {losses}')
    step_ms = {1: [], 2: []}
    for prev, cur in zip(marks, marks[1:]):
        if cur[0] == 'train':
            step_ms[1 if cur[1] <= P1 else 2].append(1e3 * (cur[2] - prev[2]))
    p1, p2 = step_ms[1][2:], step_ms[2][1:]
    log(f'kg_train ({policy}): {EPOCHS} epochs ({P1} phase 1) through '
        f'dbp15k.main in {time.perf_counter() - t0:.1f}s; launches '
        f'{[counts[k] for k in KG_KERNELS]} (topk / sparse consensus fwd / '
        f'bwd / blocked / rng per step: phase 1 1/0/0/24/1, its eval '
        f'1/0/0/12/0, phase 2 1/10/10/144/2, phase-2 eval 1/10/0/78/1); '
        f'dispatch kernel in {dtype} (the draws float32); blocked '
        f'launches by (path, C, rows) {BLOCKED_MAIN}; losses '
        f'{losses[0]:.4f} -> '
        f'{losses[P1 - 1]:.4f} (phase 1), {losses[P1]:.4f} -> '
        f'{losses[-1]:.4f} (phase 2)')
    log(f'kg_train ({policy}): step ms (host clock, synchronized): phase 1 '
        f'median {statistics.median(p1):.3f} (min {min(p1):.3f}, max '
        f'{max(p1):.3f}, steps 3-{P1}), phase 2 median '
        f'{statistics.median(p2):.3f} (min {min(p2):.3f}, max {max(p2):.3f}, '
        f'steps {P1 + 2}-{EPOCHS}); max_memory_allocated {peak} bytes '
        f'({peak / 2**30:.3f} GiB)')
    return losses, peak, (p1, p2), state


def phase_kg_train(results):
    from dgmc_tpu_torch.experiments import dbp15k
    from dgmc_tpu_torch.models.dgmc import draw_negatives, draw_noise
    from dgmc_tpu_torch.ops.topk import chunked_topk
    from dgmc_tpu_torch.train.steps import batch_to_device

    KG_LOSSES['f32'] = _kg_main_path(results, 'f32')[0]

    # The first phase-2 step against the CPU plain path at 1500 / 2000
    # entities: same weights (ψ₁'s dropout off), shortlist, noise and
    # negatives.
    args = dbp15k.parse_args(KG_ARGV + F32_ARGV + KG_SMALL)
    train_b, _, in_dim = dbp15k.synthetic_batches(args)
    model = dbp15k.build(args, in_dim)
    model.psi_1.dropout = 0.0
    dev_b = batch_to_device(train_b, 'cuda')
    cpu_b = batch_to_device(train_b, 'cpu')
    probe = copy.deepcopy(model).cuda().eval()
    with torch.no_grad():
        h = [probe.psi_1(g.x, g) for g in dev_b[:2]]
        S_idx = chunked_topk(h[0], h[1], args.k).cpu()
        hc = [model.eval().psi_1(g.x, g) for g in cpu_b[:2]]
        diff_rows = int((chunked_topk(hc[0], hc[1], args.k).long()
                         != S_idx.long()).any(-1).sum())
    N_s, N_t = args.syn_nodes_s, args.syn_nodes_t

    def run(dev, dtype, seed):
        # Each device draws the noise and negatives itself (one stream),
        # as the CLI's step draws them from its seed.
        r_s = draw_noise(args.num_steps, 1, N_s, args.rnd_dim, seed=seed,
                         device=dev)
        neg = draw_negatives(torch.tensor([N_t], device=dev), N_s,
                             min(args.k, N_t - args.k), seed=seed)
        return _kg_loss_and_grads(copy.deepcopy(model), train_b, S_idx,
                                  r_s, neg, dev, dtype)

    # The draws of the CLI's first GRAD_DRAWS phase-2 steps.
    draws = _first_steps([(
        f'kg_train: phase-2 step {e} at {N_s}/{N_t} entities',
        lambda dev, dtype, seed=dbp15k.noise_seed(args.seed, 0, e): run(
            dev, dtype, seed))
        for e in range(args.phase1_epochs + 1,
                       args.phase1_epochs + 1 + GRAD_DRAWS)])
    log(f'kg_train: the CPU plain top-k differs from the kernel\'s '
        f'shortlist in {diff_rows} of {N_s} rows (near ties; both runs '
        f'take the kernel\'s)')
    _hold_grads('kg_train', draws)

    def two_steps():
        got = []
        dbp15k.main(KG_ARGV + F32_ARGV + ['--epochs', '2',
                                          '--phase1_epochs', '0'],
                    hook=lambda k, e, o: got.append(o['loss'].item())
                    if k == 'train' else None)
        return got

    run_a, run_b = two_steps(), two_steps()
    if run_a != run_b:
        raise AssertionError(f'two 2-step runs differ: {run_a} vs {run_b}')
    log(f'kg_train: two 2-step phase-2 runs from one seed give bit-identical '
        f'losses {run_a}')

    # Informational: host work and a profile of one phase-2 step.
    args = dbp15k.parse_args(KG_ARGV + F32_ARGV)
    run = kg_step()
    run()
    t0 = time.perf_counter()
    draw_noise(args.num_steps, 1, args.syn_nodes_s, args.rnd_dim, seed=1,
               device='cuda')
    draw_negatives(torch.tensor([args.syn_nodes_t], device='cuda'),
                   args.syn_nodes_s, args.k, seed=1)
    torch.cuda.synchronize()
    log(f'kg_train: drawing the indicator noise and the negatives of a '
        f'phase-2 step on the card (host clock, synchronized) '
        f'{(time.perf_counter() - t0) * 1e3:.3f} ms')
    _step_profile(run, 'one phase-2 step')



#: The float32 KG main path's losses (``phase_kg_train``), which the
#: ``--aot_compile`` run of ``phase_capture`` must repeat.
KG_LOSSES = {}
#: Steps each comparison of ``phase_capture`` runs on both paths.
CAPTURE_STEPS = 5


def _clone(out):
    return {k: v.clone() for k, v in out.items()}


def _hold_identical(label, eager, captured,
                    what='the eager step and the replay'):
    """Two dicts of tensors bit-identical; else name the first that
    differs (between ``what``) and by how much."""
    if set(eager) != set(captured):
        raise AssertionError(f'{label}: keys {sorted(eager)} against '
                             f'{sorted(captured)}')
    for k, v in eager.items():
        w = captured[k]
        if v.shape != w.shape or v.dtype != w.dtype or not torch.equal(v, w):
            diff = ((v.double() - w.double()).abs().max().item()
                    if v.shape == w.shape else 'shape')
            raise AssertionError(f'{label}: {k} differs between {what} '
                                 f'(max |diff| {diff})')


def _hold_states(label, models, states):
    """Parameters, Adam moments, buffers (batch norm's running averages)
    and step counts of the eager (``False``) and captured (``True``) runs
    bit-identical."""
    got = {}
    for jit in (False, True):
        opt = states[jit].optimizer
        got[jit] = {}
        for name, p in models[jit].named_parameters():
            got[jit][name] = p.detach()
            for k, v in opt.state[p].items():
                got[jit][f'{name} adam {k}'] = v
        for name, b in models[jit].named_buffers():
            got[jit][f'{name} buffer'] = b
    _hold_identical(f'{label}: parameters, Adam state and buffers',
                    got[False], got[True])
    if states[False].step != states[True].step:
        raise AssertionError(f'{label}: host step counts differ')
    return len(got[True])


def _both(label, kernels, runs, want=None):
    """Run each call of ``runs`` (``[(name, {jit: fn})]``) on the eager
    (``False``) and the captured (``True``) path in turn: outputs
    bit-identical, the launches of ``kernels`` per call equal on both (and
    to ``want[name]`` where given)."""
    from dgmc_tpu_torch.ops.kernels import dispatch
    for name, fns in runs:
        outs, launches = {}, {}
        for jit in (False, True):
            before = dispatch.launch_counts()
            outs[jit] = _clone(fns[jit]())
            torch.cuda.synchronize()
            after = dispatch.launch_counts()
            launches[jit] = tuple(after[k] - before[k] for k in kernels)
        _hold_identical(f'{label} {name}', outs[False], outs[True])
        if launches[False] != launches[True]:
            raise AssertionError(f'{label} {name}: launches {launches[True]} '
                                 f'per replay, {launches[False]} per eager '
                                 f'step ({kernels})')
        if want is not None and launches[True] != want(name):
            raise AssertionError(f'{label} {name}: launches '
                                 f'{launches[True]}, expected {want(name)}')


def _graph_report(label, step):
    """Log each record of a compiled step: its signature's capture
    seconds (warm-up included), launches per replay and static memory;
    returns the memory of each."""
    from dgmc_tpu_torch.obs.memory import captured_memory
    mems = []
    for rec in step.jit.compiled.records.values():
        mem = captured_memory(rec)
        mems.append(mem)
        log(f'capture: {label}: captured in {rec.capture_s:.3f}s, '
            f'{sum(rec.launches.values())} launches of the port\'s kernels '
            f'a replay, static memory ' + ', '.join(
                f'{k} {v}' for k, v in mem.items()))
    return mems


def _capture_dense(policy):
    """The dense train and eval steps, eager (``jit=False``) and captured,
    from one initial state over the CLI's first CAPTURE_STEPS batches and
    seeds and two held-out batches."""
    from dgmc_tpu_torch.data.synthetic import RandomGraphPairs
    from dgmc_tpu_torch.experiments import pascal_pf
    from dgmc_tpu_torch.train.state import create_train_state
    from dgmc_tpu_torch.train.steps import (HostBatches, make_eval_step,
                                            make_train_step)
    from dgmc_tpu_torch.utils.data import PairLoader
    args = pascal_pf.parse_args(['--seed', '0', '--precision', policy])
    model, loader, transform = pascal_pf.build(args)
    models = {jit: copy.deepcopy(model).cuda() for jit in (False, True)}
    states = {jit: create_train_state(m, args.lr)
              for jit, m in models.items()}
    train = {jit: make_train_step(m, loss_on_s0=True, jit=jit)
             for jit, m in models.items()}
    evals = {jit: make_eval_step(m, jit=jit) for jit, m in models.items()}
    loader.dataset.set_epoch(1)
    batches = list(itertools.islice(HostBatches(loader, 'cuda'),
                                    CAPTURE_STEPS))
    eval_ds = RandomGraphPairs(30, 60, 0, 20, transform=transform,
                               length=128, seed=args.seed + 10_000)
    eval_batches = list(HostBatches(PairLoader(
        eval_ds, args.batch_size, shuffle=False,
        num_nodes=pascal_pf.NUM_NODES, num_edges=pascal_pf.NUM_EDGES),
        'cuda'))

    def train_run(i, batch):
        seed = pascal_pf.noise_seed(args.seed, 0, 1, i)
        return {jit: functools.partial(
            lambda jit, b, s: train[jit](states[jit], b, s)[1], jit, batch,
            seed) for jit in (False, True)}

    def eval_run(i, batch):
        seed = pascal_pf.noise_seed(args.seed, 1, 1, i)
        return {jit: functools.partial(evals[jit], batch, seed)
                for jit in (False, True)}

    label = f'dense {policy}'
    _both(label, TRAIN_KERNELS,
          [(f'train step {i}', train_run(i, b))
           for i, b in enumerate(batches)]
          + [(f'eval batch {i}', eval_run(i, b))
             for i, b in enumerate(eval_batches)],
          want=lambda name: PER_TRAIN_STEP if name.startswith('train')
          else PER_EVAL_BATCH)
    n = _hold_states(label, models, states)
    log(f'capture: {label}: {CAPTURE_STEPS} train steps and '
        f'{len(eval_batches)} eval batches bit-identical to the eager '
        f'steps (losses, metrics; then {n} parameters and Adam tensors); '
        f'launches per step {PER_TRAIN_STEP} / per eval batch '
        f'{PER_EVAL_BATCH} on both')
    _graph_report(f'{label} train step', train[True])
    _graph_report(f'{label} eval step', evals[True])


def _capture_kg(policy):
    """The four KG steps (phase 1, its eval, phase 2, its eval), eager
    (``jit=False``) and captured, from one initial state, CAPTURE_STEPS
    each at the CLI's seeds (ψ₁'s dropout masks included)."""
    from dgmc_tpu_torch.experiments import dbp15k
    from dgmc_tpu_torch.train.state import create_train_state
    from dgmc_tpu_torch.train.steps import (batch_to_device, make_eval_step,
                                            make_train_step)
    args = dbp15k.parse_args(KG_ARGV + ['--precision', policy])
    train_b, test_b, in_dim = dbp15k.synthetic_batches(args)
    model = dbp15k.build(args, in_dim)
    models = {jit: copy.deepcopy(model).cuda() for jit in (False, True)}
    states = {jit: create_train_state(m, args.lr)
              for jit, m in models.items()}
    steps_ = {(name, jit): fn for jit, m in models.items() for name, fn in (
        ('phase1', make_train_step(m, num_steps=0, jit=jit)),
        ('phase2', make_train_step(m, num_steps=args.num_steps, detach=True,
                                   jit=jit)),
        ('eval1', make_eval_step(m, hits_ks=(10,), num_steps=0, jit=jit)),
        ('eval2', make_eval_step(m, hits_ks=(10,),
                                 num_steps=args.num_steps, jit=jit)))}
    train_dev = batch_to_device(train_b, 'cuda')
    test_dev = batch_to_device(test_b, 'cuda')
    runs, phase_of = [], {}
    for phase, split, first in (('phase1', 0, 1), ('eval1', 1, 1),
                                ('phase2', 0, args.phase1_epochs + 1),
                                ('eval2', 1, args.phase1_epochs + 1)):
        for e in range(first, first + CAPTURE_STEPS):
            seed = dbp15k.noise_seed(args.seed, split, e)
            fns = {}
            for jit in (False, True):
                fn = steps_[(phase, jit)]
                fns[jit] = (functools.partial(
                    lambda fn, jit, s: fn(states[jit], train_dev, s)[1], fn,
                    jit, seed) if phase.startswith('phase') else
                    functools.partial(fn, test_dev, seed))
            runs.append((f'{phase} epoch {e}', fns))
            phase_of[f'{phase} epoch {e}'] = phase
    per = {'phase1': KG_PER[('train', 1)], 'eval1': KG_PER[('eval', 1)],
           'phase2': KG_PER[('train', 2)], 'eval2': KG_PER[('eval', 2)]}
    label = f'KG {policy}'
    _both(label, KG_KERNELS, runs, want=lambda name: per[phase_of[name]])
    n = _hold_states(label, models, states)
    log(f'capture: {label}: phase 1, eval1, phase 2 and eval2, '
        f'{CAPTURE_STEPS} steps each, bit-identical to the eager steps '
        f'(losses, metrics, ψ₁\'s dropout included; then {n} parameters '
        f'and Adam tensors); launches per step as kg_train\'s on both')
    for name in ('phase1', 'eval1', 'phase2', 'eval2'):
        _graph_report(f'{label} {name}', steps_[(name, True)])


def _capture_aot():
    """``dbp15k.main --aot_compile`` (float32, 12 epochs, 10 of phase 1):
    the four ``aot_memory_*`` events logged with their memory, one
    printed line each, and losses bit-identical to the first 12 of the
    float32 KG main path without the flag."""
    import tempfile
    from dgmc_tpu_torch.experiments import dbp15k
    losses = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'metrics.jsonl')
        dbp15k.main(KG_ARGV + F32_ARGV + [
            '--epochs', '12', '--phase1_epochs', '10', '--aot_compile',
            '--metrics_log', path],
            hook=lambda k, e, o: losses.append(float(o['loss']))
            if k == 'train' else None)
        with open(path) as f:
            events = [json.loads(line) for line in f]
    aot = {e['event']: e for e in events if 'event' in e}
    names = [f'aot_memory_{n}' for n in ('phase1_step', 'eval1_step',
                                         'train_step', 'eval_step')]
    if sorted(aot) != sorted(names):
        raise AssertionError(f'--aot_compile logged {sorted(aot)}')
    for name in names:
        e = aot[name]
        if not (e['total_bytes'] == e['argument_bytes'] + e['output_bytes']
                + e['temp_bytes'] and e['temp_bytes'] > 0):
            raise AssertionError(f'{name}: {e}')
        log(f'capture: --aot_compile {name}: ' + ', '.join(
            f'{k} {e[k]}' for k in ('argument_bytes', 'output_bytes',
                                    'temp_bytes', 'total_bytes',
                                    'capture_s')))
    want = KG_LOSSES.get('f32', [])[:12]
    if losses != want:
        raise AssertionError(f'--aot_compile losses {losses} differ from '
                             f'the run without the flag {want}')
    log(f'capture: dbp15k.main --aot_compile: 4 aot_memory events, losses '
        f'of its 12 epochs bit-identical to kg_train\'s without the flag')


def phase_capture():
    """The captured steps against the eager ones on the card (see the
    module docstring)."""
    for policy in ('f32', 'bf16'):
        _capture_dense(policy)
        _capture_kg(policy)
    _capture_aot()


# ---- The backbones phase: batch norm, GIN, and ψ₂ once per step ----

#: Buckets of the backbones phase's serving part.
BN_BUCKETS = '16x48,64x192'
#: The batch-norm KG model's steps of each kind, eager and captured.
BN_KG_SCHEDULE = (('phase1', 3), ('phase2', 3), ('eval2', 1))


def bn_kg_model(args, in_dim):
    """The KG CLI's model (:func:`dbp15k.build`: its widths, depth, k and
    seeded weights) with batch norm in ψ₁ and ψ₂, which the JAX package's
    ``RelCNN(batch_norm=True)`` has and its CLI leaves off. ψ₂ with batch
    norm is not channel-packed: each consensus step calls it on the
    source and then on the target."""
    from dgmc_tpu_torch.models import DGMC, RelCNN, precision
    prec = precision.from_args(args)
    psi_1 = RelCNN(in_dim, args.dim, args.num_layers, batch_norm=True,
                   dropout=0.5, dtype=prec)
    psi_2 = RelCNN(args.rnd_dim, args.rnd_dim, args.num_layers,
                   batch_norm=True, dtype=prec)
    return DGMC(psi_1, psi_2, num_steps=args.num_steps, k=args.k,
                generator=torch.Generator().manual_seed(args.seed),
                dtype=prec)


@contextlib.contextmanager
def recording(calls):
    """Within the block, each kernel wrapper the model calls (the top-k
    search, the dense and the sparse consensus, the spline routing, the
    blocked aggregation)
    files the inputs of its first call in ``calls`` by kernel, then runs
    as it would: the path's own shapes and values, for
    :func:`hold_path_kernels` after the step."""
    from dgmc_tpu_torch.models import dgmc as dgmc_mod
    from dgmc_tpu_torch.models import spline as spline_mod
    from dgmc_tpu_torch.ops import blocked
    from dgmc_tpu_torch.ops.kernels import sparse_consensus
    sites = [(dgmc_mod, 'chunked_topk', 'topk'),
             (dgmc_mod, 'consensus_update', 'consensus'),
             (sparse_consensus, 'fused_candidate_delta', 'sparse_consensus'),
             (spline_mod, 'route_aggregate', 'spline'),
             (blocked, '_aggregate', 'blocked')]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in sites]
    for (mod, name, key), (_, _, fn) in zip(sites, saved):
        def filed(*args, _fn=fn, _key=key, **kw):
            calls.setdefault(_key, (tuple(
                a.detach() if torch.is_tensor(a) else a for a in args), kw))
            return _fn(*args, **kw)
        setattr(mod, name, filed)
    try:
        yield calls
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def hold_path_kernels(label, calls):
    """Each kernel a path called (:func:`recording`), held against its
    plain version on the card on the inputs the path gave it: top-k by
    :func:`hold_near_ties` (float32) or :func:`hold_bf16_topk`; the
    sparse consensus forward and, for a random float32 cotangent, its
    backward; the dense consensus forward; the spline routing forward
    and ``d_t``; the blocked aggregation; float32 outputs by :func:`hold_close`, bf16 ones by
    :func:`hold_ulp` → ``{kernel: max |err|}``."""
    from dgmc_tpu_torch.ops.kernels.consensus import (consensus_fwd,
                                                      plain_consensus)
    from dgmc_tpu_torch.ops.kernels.sparse_consensus import (
        plain_sparse_consensus_bwd, plain_sparse_consensus_fwd,
        sparse_consensus_bwd, sparse_consensus_fwd)
    from dgmc_tpu_torch.ops.kernels.spline import (plain_route_aggregate,
                                                   plain_route_d_t,
                                                   route_d_t, route_fwd)
    gen = torch.Generator(device='cuda').manual_seed(0)
    errs = {}
    if 'topk' in calls:
        (h_s, h_t, k), kw = calls['topk']
        hold = hold_bf16_topk if h_s.dtype == BF16 else hold_near_ties
        errs['topk'] = hold(label, h_s, h_t, k, kw.get('t_mask'))
    if 'sparse_consensus' in calls:
        (o_s, o_t, sl, w1, b1, w2, b2), _ = calls['sparse_consensus']
        out, state = sparse_consensus_fwd(o_s, o_t, sl, w1, b1, w2, b2,
                                          return_state=True)
        errs['sparse_consensus_fwd'] = hold_close(
            f'{label} sparse consensus forward', out,
            plain_sparse_consensus_fwd(o_s, o_t, sl, w1, b1, w2, b2))
        g = torch.randn(out.shape, generator=gen, device='cuda')
        hold = hold_ulp if o_s.dtype == BF16 else hold_close
        errs['sparse_consensus_bwd'] = max(
            hold(f'{label} sparse consensus backward {name}', x, w)
            for name, x, w in zip(
                SC_GRADS,
                sparse_consensus_bwd(o_s, o_t, sl, w1, b1, w2, g, state),
                plain_sparse_consensus_bwd(o_s, o_t, sl, w1, b1, w2, g)))
    if 'blocked' in calls:
        from dgmc_tpu_torch.ops import blocked as blocked_ops
        from dgmc_tpu_torch.ops.kernels import blocked
        (h, blocks), _ = calls['blocked']
        errs['blocked'] = hold_close(f'{label} blocked',
                                     blocked.aggregate(h, blocks),
                                     blocked_ops.plain_aggregate(h, blocks))
    if 'consensus' in calls:
        a, _ = calls['consensus']
        errs['consensus_fwd'] = hold_close(f'{label} consensus',
                                           consensus_fwd(*a),
                                           plain_consensus(*a))
    if 'spline' in calls:
        (t, basis, routing), _ = calls['spline']
        hold = hold_ulp if t.dtype == BF16 else hold_close
        out = route_fwd(t, basis, routing)
        errs['spline_route_fwd'] = hold(f'{label} route_fwd', out,
                                        plain_route_aggregate(t, basis,
                                                              routing))
        g = torch.randn(out.shape, generator=gen, device='cuda').to(
            out.dtype)
        errs['spline_route_bwd'] = hold(f'{label} route_d_t',
                                        route_d_t(g, basis, routing),
                                        plain_route_d_t(g, basis, routing))
    torch.cuda.synchronize()
    log(f'backbones: {label}: each kernel against its plain version on the '
        f'path\'s own inputs (max |err|): '
        + ', '.join(f'{k} {v:.3g}' for k, v in errs.items()))
    return errs


def _eager_and_captured(label, model, lr, make_steps, schedule, kernels,
                        want):
    """``schedule`` (``[(name, step key, batch, seed)]``; keys starting
    with ``train`` or ``phase`` are train steps) on the eager
    (``jit=False``) and the captured path, each from a copy of ``model``
    (:func:`_both`: outputs bit-identical, launches of ``kernels`` per
    call equal on both and to ``want[key]``), the launch counters at 0
    just before and read just after, every kernel of ``kernels`` that
    ``want`` expects launched; then parameters, Adam state and batch-norm
    buffers bit-identical (:func:`_hold_states`). The eager calls record
    the kernels' inputs (:func:`recording`). Returns ``(models, calls,
    psi_2 calls of each eager call, launches)``."""
    from dgmc_tpu_torch.ops.kernels import dispatch
    from dgmc_tpu_torch.train.state import create_train_state
    models = {jit: copy.deepcopy(model).cuda() for jit in (False, True)}
    states = {jit: create_train_state(m, lr) for jit, m in models.items()}
    steps_ = {jit: make_steps(m, jit) for jit, m in models.items()}
    seen, per_call, calls, key_of = [], {}, {}, {}
    models[False].psi_2.register_forward_hook(lambda *_: seen.append(1))

    def run(jit, name, key, batch, seed):
        step = steps_[jit][key]
        n0 = len(seen)
        with recording(calls) if not jit else contextlib.nullcontext():
            out = (step(states[jit], batch, seed)[1]
                   if key.startswith(('train', 'phase'))
                   else step(batch, seed))
        if not jit:
            per_call[name] = len(seen) - n0
        return out

    runs = []
    for name, key, batch, seed in schedule:
        key_of[name] = key
        runs.append((name, {jit: functools.partial(run, jit, name, key,
                                                   batch, seed)
                            for jit in (False, True)}))
    dispatch.reset()
    _both(label, kernels, runs, want=lambda name: want[key_of[name]])
    counts = dispatch.launch_counts()
    used = {k for per in want.values() for k, n in zip(kernels, per) if n}
    idle = [k for k in sorted(used) if not counts[k]]
    if idle:
        raise AssertionError(f'{label}: {idle} never launched')
    n = _hold_states(label, models, states)
    log(f'backbones: {label}: {len(schedule)} calls '
        f'({", ".join(name for name, *_ in schedule)}) bit-identical to '
        f'the eager ones (outputs, then {n} parameters, Adam tensors and '
        f'batch-norm buffers); launches of {kernels} per call: '
        + ', '.join(f'{k} {want[k]}' for k in sorted(want))
        + f' on both; in all {dict((k, counts[k]) for k in kernels)}; '
        f'ψ₂ calls per eager call {per_call}; dispatch dtypes '
        + str({k: d.get('dtypes') for k, d in dispatch.decisions().items()
               if k in kernels}))
    return models, calls, per_call, counts


def _bn_kg_part(policy):
    """(a) The KG training path with batch norm (:func:`bn_kg_model`) at
    the DBP15K widths and sizes: phase-1 steps, phase-2 steps and a
    phase-2 eval pass, eager against captured; ψ₂ called 2 x num_steps
    times a phase-2 step, where the CLI's packed model makes num_steps +
    1 calls; the top-k and sparse consensus kernels held on the path's
    inputs. Returns the captured model (trained)."""
    from dgmc_tpu_torch.experiments import dbp15k
    from dgmc_tpu_torch.ops.kernels import dispatch
    from dgmc_tpu_torch.train.steps import (batch_to_device, make_eval_step,
                                            make_train_step)
    args = dbp15k.parse_args(KG_ARGV + ['--precision', policy])
    train_b, test_b, in_dim = dbp15k.synthetic_batches(args)
    model = bn_kg_model(args, in_dim)
    if model.packs_source(args.num_steps):
        raise AssertionError('a ψ₂ with batch norm was channel-packed')

    def make_steps(m, jit):
        return {'phase1': make_train_step(m, num_steps=0, jit=jit),
                'phase2': make_train_step(m, num_steps=args.num_steps,
                                          detach=True, jit=jit),
                'eval2': make_eval_step(m, hits_ks=(10,),
                                        num_steps=args.num_steps, jit=jit)}

    train_dev = batch_to_device(train_b, 'cuda')
    test_dev = batch_to_device(test_b, 'cuda')
    schedule, epoch = [], 1
    for key, count in BN_KG_SCHEDULE:
        split = 1 if key.startswith('eval') else 0
        for _ in range(count):
            schedule.append((f'{key} epoch {epoch}', key,
                             test_dev if split else train_dev,
                             dbp15k.noise_seed(args.seed, split, epoch)))
            epoch += 1
    # ψ₂ runs per step on each side: 12 blocked launches a step's forward
    # where the packed model makes 6 + 6 / step.
    blocked = {'phase1': 24, 'phase2': 12 + 2 * 120, 'eval2': 12 + 120}
    want = {key: tuple(blocked[key] if k == 'blocked' else v
                       for k, v in zip(KG_KERNELS, KG_PER[per]))
            for key, per in (('phase1', ('train', 1)),
                             ('phase2', ('train', 2)),
                             ('eval2', ('eval', 2)))}
    label = f'(a) KG batch norm {policy}'
    models, calls, per_call, _ = _eager_and_captured(
        label, model, args.lr, make_steps, schedule, KG_KERNELS, want)
    psi2 = {per_call[name] for name, key, *_ in schedule
            if key != 'phase1'}
    if psi2 != {2 * args.num_steps}:
        raise AssertionError(f'{label}: ψ₂ calls per phase-2 call {psi2}')
    d = dispatch.decisions()
    # The packed form's count, on the CLI's own model and batch.
    packed = dbp15k.build(args, in_dim).cuda().train()
    seen = []
    packed.psi_2.register_forward_hook(lambda *_: seen.append(1))
    with torch.no_grad():
        packed(train_dev.graph_s, train_dev.graph_t, y=train_dev.y,
               y_mask=train_dev.y_mask, num_steps=args.num_steps,
               detach=True, generator=torch.Generator(device='cuda'))
    if len(seen) != args.num_steps + 1:
        raise AssertionError(f'{label}: the packed model called ψ₂ '
                             f'{len(seen)} times')
    log(f'backbones: {label}: ψ₂ calls per phase-2 step and eval '
        f'{2 * args.num_steps} (per step, batch norm) where the CLI\'s '
        f'packed model makes {len(seen)}')
    hold_path_kernels(label, calls)
    if policy == 'bf16' and (
            d['topk']['reason'] != 'tensor-core'
            or 'kernel:bfloat16' not in d['sparse_consensus_fwd']['dtypes']):
        raise AssertionError(f'{label}: dispatch {d}')
    return models[True]


def _gin_dense_part(policy):
    """(b) Dense DGMC with GIN ψ₁ and ψ₂ (batch norm) on PascalPF's
    batches (64 pairs, 80 nodes / 640 edges), eager against captured:
    train steps and an eval batch, ``consensus_update`` 10 times a step;
    the consensus kernel held on the path's inputs."""
    from dgmc_tpu_torch.experiments import pascal_pf
    from dgmc_tpu_torch.models import DGMC, GIN, precision
    from dgmc_tpu_torch.train.steps import (HostBatches, make_eval_step,
                                            make_train_step)
    args = pascal_pf.parse_args(['--seed', '0', '--precision', policy])
    _, loader, _ = pascal_pf.build(args)
    prec = precision.from_args(args)
    model = DGMC(GIN(1, args.dim, args.num_layers, batch_norm=True,
                     cat=False, dtype=prec),
                 GIN(args.rnd_dim, args.rnd_dim, args.num_layers,
                     batch_norm=True, dtype=prec),
                 num_steps=args.num_steps, k=-1,
                 generator=torch.Generator().manual_seed(args.seed),
                 dtype=prec)
    loader.dataset.set_epoch(1)
    batches = list(itertools.islice(HostBatches(loader, 'cuda'), 3))

    def make_steps(m, jit):
        return {'train': make_train_step(m, loss_on_s0=True, jit=jit),
                'eval': make_eval_step(m, jit=jit)}

    schedule = [(f'train step {i}', 'train', b,
                 pascal_pf.noise_seed(args.seed, 0, 1, i))
                for i, b in enumerate(batches[:2])]
    schedule.append(('eval batch 0', 'eval', batches[2],
                     pascal_pf.noise_seed(args.seed, 1, 1, 0)))
    label = f'(b) dense GIN {policy}'
    _, calls, per_call, _ = _eager_and_captured(
        label, model, args.lr, make_steps, schedule, ('consensus_fwd', 'rng'),
        {'train': (args.num_steps, 1), 'eval': (args.num_steps, 1)})
    if set(per_call.values()) != {2 * args.num_steps}:
        raise AssertionError(f'{label}: ψ₂ calls {per_call}')
    hold_path_kernels(label, calls)


def _spline_sparse_part():
    """(c) Sparse DGMC (k = 10) with the dense CLI's SplineCNN ψ₁ and ψ₂
    on its batches: one training step, eager against captured; top-k,
    the sparse consensus and the spline routing held on the path's
    inputs."""
    from dgmc_tpu_torch.experiments import pascal_pf
    from dgmc_tpu_torch.models import DGMC
    from dgmc_tpu_torch.train.steps import HostBatches, make_train_step
    args = _train_args()
    dense, loader, _ = pascal_pf.build(args)
    model = DGMC(dense.psi_1, dense.psi_2, num_steps=args.num_steps, k=10,
                 generator=torch.Generator().manual_seed(args.seed))
    loader.dataset.set_epoch(1)
    batch = next(iter(HostBatches(loader, 'cuda')))
    kernels = ('topk', 'sparse_consensus_fwd', 'sparse_consensus_bwd',
               'spline_route_fwd', 'spline_route_bwd', 'spline_records',
               'rng')
    label = '(c) sparse SplineCNN f32'
    _, calls, per_call, _ = _eager_and_captured(
        label, model, args.lr,
        lambda m, jit: {'train': make_train_step(m, loss_on_s0=True,
                                                 jit=jit)},
        [('train step 0', 'train', batch,
          pascal_pf.noise_seed(args.seed, 0, 1, 0))],
        kernels, {'train': (1, args.num_steps, args.num_steps, 44, 44, 2, 2)})
    if set(per_call.values()) != {2 * args.num_steps}:
        raise AssertionError(f'{label}: ψ₂ calls {per_call}')
    hold_path_kernels(label, calls)


def _bn_serve_part(model):
    """(d) ``MatchEngine`` over the trained batch-norm KG model (eval
    mode: the running averages; ψ₂ once per step inside each bucket's
    graph): each query's answer from the captured bucket bit-identical to
    the eager engine's, 1 / 10 / 1 top-k / sparse-consensus / draw
    launches and 20 ψ₂ calls a query."""
    from dgmc_tpu_torch.ops.kernels import dispatch
    from dgmc_tpu_torch.serve.cli import dbp15k_kg
    from dgmc_tpu_torch.serve.client import sample_query
    from dgmc_tpu_torch.serve.corpus import Corpus, load_or_build
    from dgmc_tpu_torch.serve.engine import MatchEngine
    from dgmc_tpu_torch.serve.router import QueryRouter
    kg = dbp15k_kg(seed=0)
    corpus = Corpus(kg.x_t, kg.senders_t, kg.receivers_t)
    model = copy.deepcopy(model).eval()
    index, _ = load_or_build(None, copy.deepcopy(model.psi_1), corpus,
                             device='cuda')
    router = QueryRouter(BN_BUCKETS, corpus.num_nodes, corpus.num_edges)
    engines = {jit: MatchEngine(copy.deepcopy(model), index, router,
                                device='cuda', jit=jit)
               for jit in (False, True)}
    for e in engines.values():
        e.warm()
    seen = []
    engines[False].model.psi_2.register_forward_hook(
        lambda *_: seen.append(1))
    steps = model.num_steps
    dispatch.reset()
    for qi, n in enumerate((16, 41, 64)):
        graph, _ = sample_query(corpus.x, n, 3 * n, seed=300 + qi)
        ans, lat = {}, {}
        for jit, engine in engines.items():
            before, n0 = dispatch.launch_counts(), len(seen)
            ans[jit] = engine.match(graph)
            lat[jit] = engine.last_latency_s * 1e3
            after = dispatch.launch_counts()
            got = tuple(after[k] - before[k] for k in
                        ('topk', 'sparse_consensus_fwd', 'rng'))
            if got != (1, steps, 1):
                raise AssertionError(f'(d) query {qi}: launches {got}')
            if not jit and len(seen) - n0 != 2 * steps:
                raise AssertionError(f'(d) query {qi}: ψ₂ calls '
                                     f'{len(seen) - n0}')
        if ans[True] != ans[False]:
            raise AssertionError(f'(d) query {qi}: the captured bucket\'s '
                                 f'answer differs from the eager one')
        log(f'backbones: (d) serve query {qi} ({n} nodes, bucket '
            f'{ans[True]["bucket"]}): captured answer bit-identical to the '
            f'eager one; latency {lat[True]:.3f} ms captured, '
            f'{lat[False]:.3f} ms eager; launches 1 / {steps} / 1 (top-k / '
            f'sparse consensus / draw), ψ₂ calls {2 * steps}')


def phase_backbones():
    """The remaining backbones on the card (see the module docstring):
    (a) the batch-norm KG path under both policies, (b) dense GIN under
    both, (c) sparse with a SplineCNN ψ₂, (d) serving the model of (a)."""
    trained = None
    for policy in ('f32', 'bf16'):
        model = _bn_kg_part(policy)
        if policy == 'f32':
            trained = model
        gc.collect()
        _gin_dense_part(policy)
        gc.collect()
    _spline_sparse_part()
    gc.collect()
    _bn_serve_part(trained)


def phase_serve(result, small, sc_small):
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
        + ', '.join(f'{w["bucket"]} {w["warm_s"]}s' for w in warm.values())
        + f', setup {time.perf_counter() - t0:.1f}s')

    queries = [sample_query(corpus.x, n, 3 * n, seed=100 + i)
               for i, n in enumerate(QUERY_NODES)]
    whole = Graph(edge_index=np.stack([kg.senders_s, kg.receivers_s]),
                  x=kg.x_s)
    queries.append((whole, kg.perm))

    # The main path: counters at 0 just before, read just after.
    steps = engine.model.num_steps
    by_rows = {}   # top-k launches by the query's padded row count
    sc_rows = {}   # sparse-consensus forward launches, the same way
    dispatch.reset()
    answers, answered = [], 0
    with rng_launches('serve'):
        for qi, (graph, gt) in enumerate(queries):
            before = dispatch.launch_counts()
            ans = engine.match(graph)
            answered += 1
            rows = router.route(graph.num_nodes, graph.num_edges).nodes
            latency_ms = engine.last_latency_s * 1e3
            after = dispatch.launch_counts()
            for name, per in (('topk', 1), ('sparse_consensus_fwd', steps),
                              ('rng', 1)):
                d = dispatch.decisions()[name]
                if d['path'] != 'kernel' or after[name] != before[name] + per:
                    raise AssertionError(f'query {qi}: {name} {d} with '
                                         f'launches {before[name]} -> '
                                         f'{after[name]}')
            again = engine.match(graph)
            answered += 1
            by_rows[rows] = (by_rows.get(rows, 0) - before['topk']
                             + dispatch.launch_counts()['topk'])
            sc_rows[rows] = (sc_rows.get(rows, 0)
                             + dispatch.launch_counts()['sparse_consensus_fwd']
                             - before['sparse_consensus_fwd'])
            if again != ans:
                raise AssertionError(f'query {qi}: a repeat gave another '
                                     f'answer')
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
    sc_launches = dispatch.launch_counts()['sparse_consensus_fwd']
    rng_count = dispatch.launch_counts()['rng']
    _hold_native_collation('serve', dispatch.decisions())
    peak = torch.cuda.max_memory_allocated()
    if (launches != answered or sc_launches != steps * answered
            or rng_count != answered):
        raise AssertionError(f'topk launched {launches} times, the '
                             f'sparse-consensus forward {sc_launches} and '
                             f'the draw {rng_count} for {answered} queries '
                             f'answered')
    log(f'serve: {answered} queries answered, topk kernel launches '
        f'{launches}, sparse-consensus forward launches {sc_launches} '
        f'({steps} per query), draw launches {rng_count} (the noise, 1 '
        f'per query); whole-graph hits@1 {hits1:.4f} (S_0 '
        f'{hits1_s0:.4f}, random weights); max_memory_allocated {peak} '
        f'bytes ({peak / 2**30:.3f} GiB)')
    result['launches'] = launches
    for n in SMALL_ROWS:
        small[n]['launches'] = by_rows.get(n, 0)
        sc_small[n]['launches'] = sc_rows.get(n, 0)
    log(f'serve: topk launches by query rows {sorted(by_rows.items())}, '
        f'sparse-consensus forward {sorted(sc_rows.items())}')

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
            profile(lambda: engine.match(queries[qi][0]), f'query {qi}')
        except Exception as e:   # the breakdown is informational only
            log(f'profile: query {qi}: not measured ({e!r})')

    # One small query on the CPU plain path, same weights and table.
    small = [b for b in router.buckets if b.nodes <= 64]
    cpu = MatchEngine(model, index, QueryRouter(
        small, corpus.num_nodes, corpus.num_edges), device='cpu')
    cpu.warm()
    want = cpu.match(queries[0][0])
    got = answers[0]
    if want['_audit'] != got['_audit']:
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

    # Each bucket's graph against the eager query path on the card, with
    # the engine's own noise and with a query's (a second graph, captured
    # at its first use).
    for w in warm.values():
        log(f'serve: bucket {w["bucket"]}: warm {w["warm_s"]}s, captured in '
            f'{w["capture_s"]}s, static memory ' + ', '.join(
                f'{k} {v}' for k, v in w['memory'].items()))
    eager = MatchEngine(copy.deepcopy(model), index, router, device='cuda',
                        jit=False)
    eager.warm()
    seen, gen = set(), torch.Generator().manual_seed(5)
    R_in = engine.model.psi_2.in_channels
    for qi, (graph, _) in enumerate(queries):
        bucket = router.route(graph.num_nodes, graph.num_edges)
        if bucket.nodes in seen:
            continue
        seen.add(bucket.nodes)
        r_s = torch.randn(steps, 1, bucket.nodes, R_in, generator=gen)
        for noise in (None, r_s):
            got, want = (e.match(graph, r_s=noise) for e in (engine, eager))
            if got != want:
                raise AssertionError(f'query {qi} (bucket {bucket.nodes}, '
                                     f'{"own" if noise is None else "its"} '
                                     f'noise): the replay\'s answer differs '
                                     f'from the eager path\'s')
    log(f'serve: every bucket\'s replayed answer ({sorted(seen)} rows, the '
        f'engine\'s noise and a query\'s own r_s) bit-identical to the '
        f'eager query path on the card')
    del eager, cpu
    gc.collect()

    # The streamed and the offload tiers: every query's answer
    # bit-identical to the device tier's (the main path's above); top-k
    # launches per query: one a source chunk of 4096 rows (streamed), one a
    # 4096-row target chunk of the host table (offload).
    chunk = 4096
    for tier in ('streamed', 'offload'):
        m = copy.deepcopy(model)
        if tier == 'streamed':
            m.stream_chunk = chunk
        t0 = time.perf_counter()
        eng = MatchEngine(m, index, router, device='cuda',
                          offload=tier == 'offload', offload_chunk=chunk)
        eng.warm()
        warm_s = time.perf_counter() - t0
        per, lat = {}, {}
        for qi, (graph, _) in enumerate(queries):
            rows = router.route(graph.num_nodes, graph.num_edges).nodes
            before = dispatch.launch_counts()['topk']
            ans = eng.match(graph)
            n = dispatch.launch_counts()['topk'] - before
            want = -(-(rows if tier == 'streamed' else corpus.num_nodes)
                     // chunk)
            if ans != answers[qi] or n != want:
                raise AssertionError(f'serve {tier}: query {qi} ({rows} '
                                     f'rows): {n} top-k launches (expected '
                                     f'{want}), answer identical to the '
                                     f'device tier\'s: {ans == answers[qi]}')
            per[rows] = n
            lat.setdefault(rows, []).append(eng.last_latency_s * 1e3)
        log(f'serve: {tier} tier ({chunk}-row chunks'
            + (f', ring depth {eng.prefetch_depth}, the host table '
               f'{eng._h_t_host.numel() * eng._h_t_host.element_size()} '
               f'bytes, no device copy' if tier == 'offload' else '')
            + f'): warm {warm_s:.1f}s; {len(queries)} answers bit-identical '
            f'to the device tier\'s; top-k launches a query by rows {per}; '
            f'latency ms by rows (host clock) '
            + ', '.join(f'{r} {statistics.median(v):.3f}'
                        for r, v in sorted(lat.items())))
        del eng, m
        gc.collect()
        torch.cuda.empty_cache()


#: Launches per train step and per eval batch at full width:
#: (spline_route_fwd, spline_route_bwd, consensus_fwd, spline_records,
#: rng). ψ₁ runs 2 layers on 2 graphs (at O = 256), ψ₂ 2 layers on 2
#: graphs in each of 10 consensus steps (at O = 64); the 22 SplineCNN calls
#: share one routing a graph batch, so its records are built twice (source
#: and target); the indicator noise is one draw.
TRAIN_KERNELS = ('spline_route_fwd', 'spline_route_bwd', 'consensus_fwd',
                 'spline_records', 'rng')
PER_TRAIN_STEP = (44, 44, 10, 2, 1)
PER_EVAL_BATCH = (44, 0, 10, 2, 1)
#: Kernels whose inputs stay float32 under either policy: the records'
#: basis weights and the draws.
F32_ALWAYS = ('spline_records', 'rng')
#: Gradients that are zero but for rounding: ψ₂'s final bias shifts o_s
#: and o_t alike, the MLP's output bias a whole row of S_hat.
ZERO_GRAD = ('psi_2.final.bias', 'mlp_out_bias')
#: First-step gradients over GRAD_DRAWS draws of the main path
#: (TRAIN_GRAD_DRAWS for the dense path, whose CPU runs take 20-35 s
#: each on the card's host), as
#: fractions of each tensor's largest |entry| (:func:`_hold_grads`): the
#: card's float64 plain path within GRAD_F64_TOL of the CPU's; the
#: kernels' float32 path within GRAD_TOL of the CPU float32 path, or else
#: no farther from the CPU float64 path than GRAD_F64_RATIO x the card's
#: float32 path without the port's kernels, in the mean over the draws
#: and at the worst draw.
GRAD_TOL, GRAD_F64_TOL, GRAD_F64_RATIO, GRAD_DRAWS = 1e-3, 1e-8, 2.0, 6
TRAIN_GRAD_DRAWS = 4


@contextlib.contextmanager
def spline_launches_by_width():
    """Within the block, file every spline kernel launch under the width
    O it ran at: ``{(kernel, O): launches}``, filled at the end of the
    block, from the wrappers' counters read around each forward and
    backward of ``route_aggregate``'s autograd function (each calls one
    wrapper once) into a :class:`Tally` (so the replays of a captured
    step count too)."""
    from dgmc_tpu_torch.ops.kernels import spline
    fn, tally, out = spline._RouteAggregate, Tally('spline'), {}
    fwd, bwd = fn.forward, fn.backward

    def counted(name, wrapper, call, x, *args):
        before = wrapper.launches
        result = call(*args)
        tally.add((name, x.shape[-1]), wrapper.launches - before)
        return result

    fn.forward = staticmethod(lambda ctx, t, basis, routing: counted(
        'spline_route_fwd', spline.route_fwd, fwd, t, ctx, t, basis,
        routing))
    fn.backward = staticmethod(lambda ctx, g: counted(
        'spline_route_bwd', spline.route_d_t, bwd, g, ctx, g))
    try:
        yield out
    finally:
        fn.forward, fn.backward = staticmethod(fwd), staticmethod(bwd)
        out.update(tally.counts())


def _hold_native_collation(label, decisions):
    """The main path collated through the C++ library only."""
    d = decisions.get('collate')
    if d is None or d['counts']['numpy'] or not d['counts']['native']:
        raise AssertionError(f'{label}: collation {d}; expected the native '
                             f'path only')
    log(f'{label}: collation native in {d["counts"]["native"]} calls, numpy '
        f'in none')


def _deltas(a, b):
    return tuple(b[k] - a[k] for k in TRAIN_KERNELS)


def _loss_and_grads(model, batch, r_s, device, dtype):
    """Loss and gradients of one training forward (``loss_on_s0``) with
    the injected noise, in ``dtype`` on ``device``."""
    from dgmc_tpu_torch.models import metrics
    from dgmc_tpu_torch.train.steps import batch_to_device
    model = model.to(device=device, dtype=dtype).train()
    g_s, g_t, y, y_mask = batch_to_device(batch, device)
    for g in (g_s, g_t):
        g.x, g.edge_attr = g.x.to(dtype), g.edge_attr.to(dtype)
    S_0, S_L = model(g_s, g_t, r_s=r_s.to(device=device, dtype=dtype))
    loss = metrics.nll_loss(S_L, y, y_mask) + metrics.nll_loss(S_0, y,
                                                               y_mask)
    loss.backward()
    if device == 'cuda':
        torch.cuda.synchronize()
    return loss.item(), {n: p.grad.detach().to('cpu', torch.float64)
                         for n, p in model.named_parameters()}


def _dense_main_path(results, policy):
    """The dense training main path through ``pascal_pf.main`` under
    ``policy`` (one epoch of 16 steps of 64 pairs, then 128 held-out
    pairs) at the PascalPF widths: the counters set to 0 just before and
    read just after, the launches per step and per width, the dispatch
    ledger (kernel, the routing and consensus in the policy's dtype),
    finite losses. Files the launches under the kernels' names
    (``_bf16`` appended under bf16) and returns ``(losses, peak bytes,
    step ms)``."""
    from dgmc_tpu_torch.experiments import pascal_pf
    from dgmc_tpu_torch.ops.kernels import dispatch
    dtype = 'bfloat16' if policy == 'bf16' else 'float32'
    tag = '_bf16' if policy == 'bf16' else ''
    marks, losses = [], []

    def hook(kind, index, out):
        torch.cuda.synchronize()
        marks.append((kind, time.perf_counter(), dispatch.launch_counts()))
        if kind == 'train':
            losses.append(float(out['loss']))

    argv = ['--seed', '0', '--precision', policy, '--epochs', '1',
            '--synthetic_eval', '128']
    torch.cuda.reset_peak_memory_stats()
    # The main path: counters at 0 just before, read just after.
    with spline_launches_by_width() as by_width, (
            rng_launches('train') if policy == 'f32'
            else contextlib.nullcontext()):
        dispatch.reset()
        marks.append(('start', time.perf_counter(),
                      dispatch.launch_counts()))
        pascal_pf.main(argv, hook=hook)
        counts = dispatch.launch_counts()
    decisions = dispatch.decisions()
    peak = torch.cuda.max_memory_allocated()
    kinds = [m[0] for m in marks[1:]]
    if kinds != ['train'] * 16 + ['eval'] * 2:
        raise AssertionError(f'expected 16 train steps and 2 eval batches, '
                             f'got {kinds}')
    for prev, cur in zip(marks, marks[1:]):
        want = PER_TRAIN_STEP if cur[0] == 'train' else PER_EVAL_BATCH
        got = _deltas(prev[2], cur[2])
        if got != want:
            raise AssertionError(f'{cur[0]} launches {got}, expected {want}')
    for name in TRAIN_KERNELS:
        d = decisions[name]
        want = 'float32' if name in F32_ALWAYS else dtype
        if (d['path'] != 'kernel' or d['counts']['plain']
                or set(d['dtypes']) != {f'kernel:{want}'}):
            raise AssertionError(f'{name}: dispatch {d}')
        if name not in F32_ALWAYS or (name != 'rng' and policy == 'f32'):
            results[name + tag]['launches'] = counts[name]
    _hold_native_collation(f'train ({policy})', decisions)
    for name in TRAIN_KERNELS[:2]:
        widths = {o: n for (k, o), n in by_width.items() if k == name}
        if sum(widths.values()) != counts[name]:
            raise AssertionError(f'{name}: launches by width {widths} do not '
                                 f'add up to {counts[name]}')
        results[f'{name}{tag}@64']['launches'] = widths.get(64, 0)
        log(f'train ({policy}): {name} launches by width O: '
            f'{sorted(widths.items())}')
    if not np.isfinite(losses).all():
        raise AssertionError(f'non-finite train loss: {losses}')
    step_ms = [1e3 * (b[1] - a[1]) for a, b in zip(marks, marks[1:])
               if b[0] == 'train'][2:]
    med = statistics.median(step_ms)
    log(f'train ({policy}): 16 steps of 64 pairs + 2 eval batches through '
        f'pascal_pf.main; launches {[counts[k] for k in TRAIN_KERNELS]} '
        f'({"/".join(map(str, PER_TRAIN_STEP))} per step, '
        f'{"/".join(map(str, PER_EVAL_BATCH))} per eval batch); dispatch '
        f'kernel for all four, in {dtype}; losses {losses[0]:.4f} -> '
        f'{losses[-1]:.4f}')
    log(f'train ({policy}): step ms after 2 warm-up steps (host clock, '
        f'synchronized, collation included): median {med:.3f}, min '
        f'{min(step_ms):.3f}, max {max(step_ms):.3f}; {64 / med * 1e3:.1f} '
        f'pairs/s; max_memory_allocated {peak} bytes ({peak / 2**30:.3f} '
        f'GiB)')
    return losses, peak, step_ms


def phase_train(results):
    from dgmc_tpu_torch.experiments import pascal_pf
    from dgmc_tpu_torch.models.dgmc import draw_noise
    from dgmc_tpu_torch.train.state import create_train_state
    from dgmc_tpu_torch.train.steps import make_train_step

    _dense_main_path(results, 'f32')

    # The CLI's first TRAIN_GRAD_DRAWS steps (its batches and its draws,
    # each device drawing its own noise: one stream) on the card against
    # the CPU plain path on the same weights (see _hold_grads).
    args = _train_args()
    model, loader, _ = pascal_pf.build(args)
    loader.dataset.set_epoch(1)
    jobs = []
    for i, batch in zip(range(TRAIN_GRAD_DRAWS), loader):
        seed = pascal_pf.noise_seed(0, 0, 1, i)
        jobs.append((
            f'train: step {i}',
            lambda dev, dtype, batch=batch, seed=seed: _loss_and_grads(
                copy.deepcopy(model), batch, draw_noise(
                    args.num_steps, args.batch_size, pascal_pf.NUM_NODES,
                    args.rnd_dim, seed=seed, device=dev), dev, dtype)))
    _hold_grads('train', _first_steps(jobs))

    def two_steps():
        model, loader, _ = pascal_pf.build(args)
        state = create_train_state(model.cuda(), learning_rate=args.lr)
        step = make_train_step(model, loss_on_s0=True)
        loader.dataset.set_epoch(1)
        got = []
        for i, batch in zip(range(2), loader):
            state, o = step(state, batch, pascal_pf.noise_seed(0, 0, 1, i))
            got.append(o['loss'].item())
        return got

    run_a, run_b = two_steps(), two_steps()
    if run_a != run_b:
        raise AssertionError(f'two 2-step runs differ: {run_a} vs {run_b}')
    log(f'train: two 2-step runs from one seed give bit-identical losses '
        f'{run_a}')
    t0 = time.perf_counter()
    next(iter(loader))
    collate_ms = (time.perf_counter() - t0) * 1e3
    # The padding alone, the C++ library against the NumPy loop, on one
    # batch.s 64 pairs (median of 50 each, host clock).
    from dgmc_tpu_torch.utils.data import pad_pair_batch
    pairs = [loader.dataset[i] for i in range(args.batch_size)]
    pad_ms = {mode: statistics.median(
        _host_ms(lambda: pad_pair_batch(pairs, pascal_pf.NUM_NODES,
                                        pascal_pf.NUM_EDGES, native=mode))
        for _ in range(50)) for mode in ('require', 'never')}
    log(f'train: padding 64 pairs (median of 50): native '
        f'{pad_ms["require"]:.3f} ms, numpy {pad_ms["never"]:.3f} ms')
    t0 = time.perf_counter()
    draw_noise(args.num_steps, args.batch_size, pascal_pf.NUM_NODES,
               args.rnd_dim, seed=1, device='cuda')
    torch.cuda.synchronize()
    noise_ms = (time.perf_counter() - t0) * 1e3
    log(f'train: host work per step: collating 64 pairs (transforms '
        f'included; the CLI does it in a prefetch thread) '
        f'{collate_ms:.3f} ms; drawing the indicator noise on the card '
        f'(synchronized) {noise_ms:.3f} ms')
    _step_profile(dense_step(), 'one train step')


#: The port's kernels among the device names a profile lists.
PORT_KERNEL = re.compile(r'::(topk_tiles|topk_tc|merge_lists|route_\w+|'
                         r'g_norm|'
                         r'\w*records|consensus_\w+|'
                         r'project_rows|sc_\w+|draw|blocked_aggregate)\b')


def port_kernels(rows):
    """``[(name, device_us, launches)]``: the port's kernels among a
    profile's rows (:func:`_profiled`), summed by kernel name, largest
    first."""
    got = {}
    for dev_us, key, count in rows:
        if m := PORT_KERNEL.search(key):
            us, n = got.get(m.group(1), (0.0, 0))
            got[m.group(1)] = (us + dev_us, n + count)
    return sorted(((k, *v) for k, v in got.items()), key=lambda r: -r[1])


def dense_step(policy='f32', jit=None):
    """One dense PascalPF training step at the CLI's defaults under
    ``policy`` on the card, as a call: one fixed batch (no collation), a
    new noise seed each call. ``jit`` as for :func:`kg_step`; the call
    carries the step (``run.step``)."""
    from dgmc_tpu_torch.experiments import pascal_pf
    from dgmc_tpu_torch.train.state import create_train_state
    from dgmc_tpu_torch.train.steps import make_train_step
    args = pascal_pf.parse_args(['--seed', '0', '--precision', policy])
    model, loader, _ = pascal_pf.build(args)
    state = create_train_state(model.cuda(), learning_rate=args.lr)
    step = make_train_step(model, loss_on_s0=True, **_jit_kw(jit))
    loader.dataset.set_epoch(1)
    batch = next(iter(loader))
    seeds = itertools.count(1)

    def run():
        return step(state, batch, next(seeds))
    run.step, run.state, run.batch = step, state, batch
    return run


def dense_loop_step(policy, spent, prefetch=False, jit=None):
    """One step of the dense CLI's loop under ``policy``, as a call: the
    next batch of the epoch's loader (collated in the step's thread:
    pinned host batches where the tree has ``HostBatches``; with
    ``prefetch``, those made in a ``PrefetchLoader``'s thread, as
    ``pascal_pf.main`` does since its steps are captured), then the train
    step. The wait for the
    batch adds to ``spent['collate']``. ``jit`` (trees that have it) picks
    the step's path; the CLI's (captured) where ``None``. The call carries
    the step (``run.step``)."""
    from dgmc_tpu_torch.experiments import pascal_pf
    from dgmc_tpu_torch.train import steps as steps_mod
    from dgmc_tpu_torch.train.state import create_train_state
    from dgmc_tpu_torch.utils import data as data_mod
    args = pascal_pf.parse_args(['--seed', '0', '--precision', policy])
    model, loader, _ = pascal_pf.build(args)
    state = create_train_state(model.cuda(), learning_rate=args.lr)
    step = steps_mod.make_train_step(model, loss_on_s0=True,
                                     **_jit_kw(jit))
    prefetch_loader = getattr(data_mod, 'PrefetchLoader', None)
    host = getattr(steps_mod, 'HostBatches', None)
    if host is None:
        batches = loader
    elif prefetch and prefetch_loader is not None:
        batches = prefetch_loader(host(loader, 'cuda'), 2)
    else:
        batches = host(loader, 'cuda')

    def epochs():
        for epoch in itertools.count(1):
            loader.dataset.set_epoch(epoch)
            yield from batches

    it, seeds = epochs(), itertools.count(1)

    def run():
        t0 = time.perf_counter()
        batch = next(it)
        spent['collate'] += time.perf_counter() - t0
        step(state, batch, next(seeds))
    run.step = step
    return run


def _jit_kw(jit):
    """``{'jit': jit}`` unless ``jit`` is None (the tree's default)."""
    return {} if jit is None else {'jit': jit}


def kg_step(policy='f32', jit=None, batch_norm=False, unblocked=False):
    """One phase-2 step of the KG training path (``dbp15k`` at its
    defaults on the synthetic alignment, ψ₁ detached) under ``policy`` on
    the card, as a call: the batch uploaded once, a new noise seed each
    call. ``batch_norm``: the model of the ``backbones`` phase
    (:func:`bn_kg_model`), whose ψ₂ runs once per step on each side.
    ``unblocked``: ``--blocked_adjacency off`` (the gather + segment
    branch; a tree without the flag has no other)."""
    from dgmc_tpu_torch.experiments import dbp15k
    from dgmc_tpu_torch.train.state import create_train_state
    from dgmc_tpu_torch.train.steps import batch_to_device, make_train_step
    args = dbp15k.parse_args(
        KG_ARGV + ['--precision', policy]
        + (['--blocked_adjacency', 'off'] if unblocked else []))
    train_b, _, in_dim = dbp15k.synthetic_batches(args)
    model = (bn_kg_model if batch_norm else dbp15k.build)(args, in_dim).cuda()
    state = create_train_state(model, learning_rate=args.lr)
    step = make_train_step(model, num_steps=args.num_steps, detach=True,
                           **_jit_kw(jit))
    dev_b = batch_to_device(train_b, 'cuda')
    seeds = itertools.count(1)

    def run():
        return step(state, dev_b, next(seeds))
    run.step, run.state, run.batch = step, state, dev_b
    return run


@contextlib.contextmanager
def host_timers():
    """Within the block, add the host time spent in the model's draws
    (``draw_noise``, ``draw_negatives``) to ``spent['draw']``, in the
    eager train step's upload (``batch_to_device``) to ``spent['upload']``
    and, where the tree has captured steps, in a graph's replay call
    (``Captured.replay``: the launch, returning before the device ends)
    to ``spent['replay']``: those functions wrapped by a timer."""
    from dgmc_tpu_torch.models import dgmc as dgmc_mod
    from dgmc_tpu_torch.train import steps as steps_mod
    spent = collections.defaultdict(float)
    wrapped = [(dgmc_mod, 'draw_noise', 'draw'),
               (dgmc_mod, 'draw_negatives', 'draw'),
               (steps_mod, 'batch_to_device', 'upload')]
    try:   # trees with captured steps: the host's time in a replay call
        from dgmc_tpu_torch.train import compiled
        wrapped.append((compiled.Captured, 'replay', 'replay'))
    except ImportError:
        pass
    originals = []
    for mod, name, part in wrapped:
        fn = getattr(mod, name)
        originals.append((mod, name, fn))

        def timed_fn(*args, _fn=fn, _part=part, **kw):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kw)
            finally:
                spent[_part] += time.perf_counter() - t0
        setattr(mod, name, timed_fn)
    try:
        yield spent
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)


#: The parts of a step's time that ``--steps`` splits out (host clock):
#: the draws, the wait for the batch, the eager step's upload, a
#: captured step's replay call, and ``wait``, the wait for the device
#: after the step call returned; ``rest`` is the remainder, the step's own
#: host work.
HOST_PARTS = ('draw', 'collate', 'upload', 'replay')


def steps(n):
    """The ``--steps`` mode: ``{step: {...}}`` for the dense step (a new
    batch each step, collated in the step's thread; ``dense_prefetch``,
    where the tree has ``PrefetchLoader`` and pinned host batches, makes
    them in the loader's thread instead, the CLI's loop since its steps
    are captured) and the KG
    phase-2 step (one uploaded batch), under each precision policy; on a
    tree with captured steps (the CLIs' default) also their eager loops,
    ``dense_eager`` and ``kg_phase2_eager``; on a tree with blocked
    adjacency also the KG steps with it off (``kg_phase2_unblocked``,
    ``kg_phase2_bn_unblocked``): ``n`` synchronized steps each
    (host clock, after 2 warm-up steps), each step's time split as
    :data:`HOST_PARTS` says (medians over the steps), then one more step
    under the profiler (device busy time and share, ops, the port's
    kernels), the dtype each kernel ran in (the dispatch ledger's) and
    each captured graph's static memory."""
    import inspect
    from dgmc_tpu_torch.ops.kernels import dispatch
    from dgmc_tpu_torch.train import steps as steps_mod
    from dgmc_tpu_torch.utils import data as data_mod
    # Trees with pinned host batches and PrefetchLoader also time the loop
    # with the batches made in its thread: what the thread takes off the
    # step.
    prefetch = (hasattr(steps_mod, 'HostBatches')
                and hasattr(data_mod, 'PrefetchLoader'))
    jit = 'jit' in inspect.signature(steps_mod.make_train_step).parameters
    # Trees with batch norm also time the captured KG phase-2 step of the
    # backbones phase, ψ₂ once per step on each side.
    bn = importlib.util.find_spec('dgmc_tpu_torch.models.norm') is not None
    # Trees with blocked adjacency (the CLI's default) also time the KG
    # steps with it off (``*_unblocked``: the gather + segment branch).
    blocked = importlib.util.find_spec(
        'dgmc_tpu_torch.ops.blocked') is not None
    names = ('dense', *(('dense_eager',) if jit else ()),
             *(('dense_prefetch',) if prefetch else ()), 'kg_phase2',
             *(('kg_phase2_unblocked',) if blocked else ()),
             *(('kg_phase2_eager',) if jit else ()),
             *(('kg_phase2_bn',) if bn else ()),
             *(('kg_phase2_bn_unblocked',) if bn and blocked else ()))
    out = {}
    for policy in ('f32', 'bf16'):
        for name in names:
            eager = False if name.endswith('_eager') else None
            with host_timers() as spent:
                dispatch.reset()
                run = (kg_step(policy, eager, '_bn' in name,
                               name.endswith('_unblocked'))
                       if name.startswith('kg')
                       else dense_loop_step(policy, spent,
                                            name == 'dense_prefetch', eager))
                for _ in range(2):
                    run()
                torch.cuda.synchronize()
                ms = []
                split = {k: [] for k in (*HOST_PARTS, 'wait', 'rest')}
                for _ in range(n):
                    spent.clear()
                    t0 = time.perf_counter()
                    run()
                    t1 = time.perf_counter()
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                    for k in HOST_PARTS:
                        split[k].append(spent[k] * 1e3)
                    split['wait'].append(ms[-1] - (t1 - t0) * 1e3)
                    split['rest'].append((t1 - t0) * 1e3 - sum(
                        spent[k] * 1e3 for k in HOST_PARTS))
                rows, wall_ms = _profiled(run)
            busy = sum(r[0] for r in rows) / 1e3
            key = f'{name} {policy}'
            r = out[key] = {
                'median_ms': statistics.median(ms), 'min_ms': min(ms),
                'max_ms': max(ms),
                'host_split_ms': {k: statistics.median(v)
                                  for k, v in split.items()},
                'profiled_wall_ms': wall_ms, 'busy_ms': busy,
                'busy_share': busy / wall_ms,
                'device_ops': sum(r[2] for r in rows),
                'kernels': {k: {'ms': us / 1e3, 'launches': c}
                            for k, us, c in port_kernels(rows)},
                'dtypes': {k: d.get('dtype')
                           for k, d in dispatch.decisions().items()},
                'graphs': _graph_memory(run.step)}
            log(f'steps: {key}: step ms median {r["median_ms"]:.3f} (min '
                f'{r["min_ms"]:.3f}, max {r["max_ms"]:.3f}, {n} steps); '
                f'split (median ms) '
                + ', '.join(f'{k} {v:.3f}'
                            for k, v in r['host_split_ms'].items())
                + f'; one step profiled: wall {wall_ms:.3f} ms, device busy '
                f'{busy:.3f} ms ({100 * r["busy_share"]:.1f}%), '
                f'{r["device_ops"]} device ops; the port\'s kernels '
                + ', '.join(f'{k} {v["ms"]:.4f} ms x{v["launches"]}'
                            for k, v in r['kernels'].items())
                + f'; dtypes {r["dtypes"]}; graphs {r["graphs"]}')
            del run
            gc.collect()
            torch.cuda.empty_cache()
    return out


def _graph_memory(step):
    """Static memory of each graph a captured step holds (none on a tree
    or path without)."""
    jitted = getattr(step, 'jit', None)
    if jitted is None or jitted.compiled is None:
        return []
    from dgmc_tpu_torch.obs.memory import captured_memory
    return [captured_memory(rec) for rec in jitted.compiled.records.values()]


def _sc_floats(gen, B, N_s, N_t, K, R):
    """Float32 inputs of the sparse consensus forward at the model's
    scales and a uniform shortlist, on the card."""
    from dgmc_tpu_torch.ops.shortlist import Shortlist
    args = [s * torch.randn(*shape, generator=gen) for s, shape in (
        (1.0, (B, N_s, R)), (1.0, (B, N_t, R)), (R ** -0.5, (R, R)),
        (0.1, (R,)), (R ** -0.5, (R, 1)), (0.1, (1,)))]
    idx = torch.randint(0, N_t, (B, N_s, K), generator=gen)
    return [a.cuda() for a in args], Shortlist(idx.cuda(), N_t)


def kernel_times():
    """The ``--kernels`` mode: device ms per call (``timed``) at the main
    path's shapes, only through entry points whose signatures the
    port's earlier trees share too (the forward's state included), so
    that two trees compare on one card:

    - the sparse consensus forward at the KG training shape ([1, 15000,
      K, 32] over 20000 targets; K = 20 writing the state, as training
      calls it, and without; K = 10 without), at the serve query shapes
      (16, 32, 64 rows, K = 10, over 20000), at the projection rule's
      edge (1000 and 2000 rows x K = 10 over as many target rows as
      candidates, every row projected, and over one more, only the
      touched rows) and past it (3000, 4000 and 6000 rows x K = 10 over
      20000);
    - the sparse consensus backward at K = 20 and 10 from the forward's
      state;
    - ``route_fwd`` at O = 256 and 64 on a training batch (records
      cached, as the two convolutions of a SplineCNN call share them),
      and one whole SplineCNN call's routing on a new ``Routing`` each
      call: its receiver and slot orders, the records' builds, two
      forwards and two ``d_t`` at O = 64 (a dense step makes 22 such
      calls; the host's wall time per call is what they cost it);
    - the top-k kernel at 16, 32 and 64 query rows over 20000 targets
      (C = 256, k = 10) beside ``torch.topk(bmm)``, its ``bmm`` and its
      ``topk`` alone;
    - where the tree has blocked adjacency, its kernel (``launch``, each
      tree's tables) on the synthetic source KG's incoming tables at the
      widths of :data:`BLOCKED_ROWS` and on the hub batch at C = 256 and
      32, float32;
    - the normal draw at the two main-path shapes of :data:`RNG_ROWS`,
      the key on the card."""
    from dgmc_tpu_torch.experiments import pascal_pf
    from dgmc_tpu_torch.models.spline import spline_routing
    from dgmc_tpu_torch.ops.graph import GraphBatch
    from dgmc_tpu_torch.ops.kernels import spline
    from dgmc_tpu_torch.ops.kernels.sparse_consensus import (
        sparse_consensus_bwd, sparse_consensus_fwd)
    from dgmc_tpu_torch.ops.kernels.topk import streaming_topk
    gen = torch.Generator().manual_seed(6)
    calls = {}
    for K in (20, 10):
        args, sl = _sc_floats(gen, 1, 15000, 20000, K, 32)
        calls[f'sc_fwd K={K}'] = functools.partial(
            sparse_consensus_fwd, args[0], args[1], sl, *args[2:])
        if K == 20:
            calls['sc_fwd K=20 state'] = functools.partial(
                sparse_consensus_fwd, args[0], args[1], sl, *args[2:],
                return_state=True)
        _, state = sparse_consensus_fwd(args[0], args[1], sl, *args[2:],
                                        return_state=True)
        g = torch.randn(sl.shape, generator=gen).cuda()
        calls[f'sc_bwd K={K}'] = functools.partial(
            sparse_consensus_bwd, *args[:2], sl, *args[2:5], g, state)
    for n, N_t in [(n, 20000) for n in SMALL_ROWS] + [
            (1000, 10000), (1000, 10001), (2000, 20000), (2000, 20001),
            (3000, 20000), (4000, 20000), (6000, 20000)]:
        args, sl = _sc_floats(gen, 1, n, N_t, 10, 32)
        calls[f'sc_fwd {n}x{N_t}'] = functools.partial(
            sparse_consensus_fwd, args[0], args[1], sl, *args[2:])
    args = _train_args()
    _, loader, _ = pascal_pf.build(args)
    graph = GraphBatch.from_numpy(next(iter(loader)).s, 'cuda')
    basis, routing = spline_routing(graph, 5)
    B, M, N = graph.x.shape[0], routing.num_rows, routing.num_nodes
    for O in (args.dim, args.rnd_dim):
        t = torch.randn(B, M, O, generator=gen).cuda()
        calls[f'route_fwd O={O}'] = functools.partial(spline.route_fwd, t,
                                                      basis, routing)
    t64 = torch.randn(B, M, args.rnd_dim, generator=gen).cuda()
    g64 = torch.randn(B, N, args.rnd_dim, generator=gen).cuda()

    def spline_call():
        fresh = spline.Routing(routing.flat, routing.receivers,
                               routing.edge_mask, N, M)
        for _ in range(2):
            spline.route_fwd(t64, basis, fresh)
            spline.route_d_t(g64, basis, fresh)
    calls['spline call O=64'] = spline_call
    B_, _, N_t, C, k = TOPK_SHAPE
    for n in SMALL_ROWS:
        h_s, h_t, _, _ = _topk_case(gen, B_, n, N_t, C, k, ints=False)
        scores = torch.bmm(h_s, h_t.transpose(1, 2))
        calls[f'topk {n}x{N_t}'] = functools.partial(streaming_topk, h_s,
                                                     h_t, k)
        calls[f'torch.topk(bmm) {n}x{N_t}'] = functools.partial(
            lambda a, b: torch.topk(torch.bmm(a, b.transpose(1, 2)), k),
            h_s, h_t)
        calls[f'bmm {n}x{N_t}'] = functools.partial(
            lambda a, b: torch.bmm(a, b.transpose(1, 2)), h_s, h_t)
        calls[f'topk of scores {n}x{N_t}'] = functools.partial(
            torch.topk, scores, k)
    if importlib.util.find_spec('dgmc_tpu_torch.ops.blocked') is not None:
        calls.update(_blocked_kernel_calls(gen))
    from dgmc_tpu_torch.ops.kernels import rng
    dev_seed = rng.seed_tensor((7 << 40) + 12345, 'cuda')
    for key, (path, kind, shape) in RNG_ROWS.items():
        if kind == 'normal':
            _, _, steps_, B, P = _rng_key(path, kind, shape)
            calls[f'draw normals {"x".join(map(str, shape))}'] = (
                functools.partial(rng.philox_normal, steps_, B, P, dev_seed,
                                  0, 0, 'cuda'))
    got, src = timed(calls)
    for key, (ms, wall) in got.items():
        log(f'kernels: {key}: {ms:.4f} ms per call [{src}] / {wall:.4f} '
            f'wall')
    for key in ('sc_fwd K=20 state', 'sc_fwd 64x20000', 'sc_bwd K=10',
                'spline call O=64', 'torch.topk(bmm) 64x20000',
                'torch.topk(bmm) 16x20000'):
        log(f'kernels: {key}: device ms by launch: '
            f'{fmt_split(launch_split(calls[key]))}')
    return {'ms_source': src, 'ms': {k: v[0] for k, v in got.items()},
            'wall_ms': {k: v[1] for k, v in got.items()}}


# ---------------------------------------------------------------------------
# Blocked adjacency and the memory tiers
# ---------------------------------------------------------------------------

#: The blocked kernel's rows: ``(main path, C, rows dtype)`` of the launches
#: filed under each (:func:`blocked_launches`): ψ₁ at C = 256 (both
#: directions, forward and backward), the packed ψ₂ (all 10 steps' source
#: sides, C = 320) and the per-step ψ₂ (C = 32) on the float32 KG path; the
#: bf16 rows at C = 256 and 320 on the bf16 path.
BLOCKED_ROWS = {'blocked': ('kg_train', 256, 'float32'),
                'blocked@C=320': ('kg_train', 320, 'float32'),
                'blocked@C=32': ('kg_train', 32, 'float32'),
                'blocked_bf16': ('kg_train_bf16', 256, 'bfloat16'),
                'blocked_bf16@C=320': ('kg_train_bf16', 320, 'bfloat16')}
#: ``{(path, C, rows dtype): launches}`` of the blocked kernel on the KG
#: main paths.
BLOCKED_MAIN = {}
@contextlib.contextmanager
def blocked_launches(path):
    """Within the block, file every launch of the blocked kernel under
    ``(path, C, rows dtype)`` in :data:`BLOCKED_MAIN`, through a
    :class:`Tally` (so the replays of a captured step count too)."""
    from dgmc_tpu_torch.ops import blocked as ob
    from dgmc_tpu_torch.ops.kernels import blocked as kb
    site = ob._aggregate   # adj_matmul's call of the wrapper
    tally = Tally(f'blocked {path}')

    def counted(h, blocks):
        before = kb.aggregate.launches
        out = site(h, blocks)
        dt = ob.operand_dtype(h.dtype, h.shape[-1], blocks.gather_dtype)
        tally.add((path, h.shape[-1], str(dt).replace('torch.', '')),
                  kb.aggregate.launches - before)
        return out

    ob._aggregate = counted
    try:
        yield
    finally:
        ob._aggregate = site
        for key, n in tally.counts().items():
            BLOCKED_MAIN[key] = BLOCKED_MAIN.get(key, 0) + n


def _blocked_work(blocks, C, elem):
    """``(flops, bytes)`` of ``blocked_work`` (``ops/kernels/blocked.py``:
    one aggregation's least work, whatever implements it)."""
    from dgmc_tpu_torch.ops.kernels.blocked import blocked_work
    work = blocked_work(blocks, C, elem)
    return work['flops'], work['bytes']


def _hub_blocks(B=2, N=1000, E=20000, seed=0):
    """Blocks of a batch with a hub (half of element 0's edges into node
    3: many blocks in one range), element 1 without (fewer blocks: padded
    ones), N no multiple of the 128-row range, and a graph without an
    edge."""
    from dgmc_tpu_torch.ops import blocked as ob
    rng = np.random.RandomState(seed)
    snd = rng.randint(0, N, (B, E))
    rcv = rng.randint(0, N, (B, E))
    rcv[0, :E // 2] = 3
    mask = rng.rand(B, E) > 0.1
    hub = ob.build_edge_blocks(snd, rcv, mask, N)
    empty = ob.build_edge_blocks(snd[:1], rcv[:1], np.zeros((1, E), bool),
                                 N)
    return [b.map(lambda t: t.cuda()) for b in (*hub, *empty)]


def phase_blocked_kernel(res):
    """The blocked kernel (``csrc/blocked.cu``) on the card against
    ``ordered_aggregate`` (torch over the row table in the kernel's order
    and rounding): bit-identical on every case; and against its plain
    version (JAX's one-hot form, ``ops/blocked.py::plain_aggregate``):
    bit-equal on integer-valued rows (every sum exact in float32), within
    rtol 1e-5 / atol 1e-5 x max|out| on random ones. The cases: a batch
    of 1000 nodes (no multiple of the 128-row range) with a hub range of
    many blocks beside an element with fewer, padded, blocks, and an
    edgeless graph; the source and target KGs' tables (100000 / 120000
    edges); each in both directions (the backward is the forward over the
    transposed tables), at C = 1, 32 (the per-step ψ₂), 40, 256 (ψ₁) and
    320 (the packed ψ₂), float32 and bf16 rows (``gather_dtype``: bf16 at
    C >= 256, widened to float32 below); every repeat bit-identical.
    Times the kernel, the plain version, ``torch.sparse.mm`` of the CSR
    adjacency (yardstick only) and the path it replaces (the port's
    ``gather_nodes`` + ``scatter_to_nodes``) at the main path's widths on
    the source KG, each with its bound, and the kernel on the hub batch
    beside its bound."""
    from dgmc_tpu_torch.experiments import dbp15k
    from dgmc_tpu_torch.ops import blocked as ob
    from dgmc_tpu_torch.ops.graph import (GraphBatch, gather_nodes,
                                          scatter_to_nodes)
    from dgmc_tpu_torch.ops.kernels import blocked as kb
    gen = torch.Generator(device='cuda').manual_seed(0)

    def ints(shape, dtype=torch.float32):
        return torch.randint(-4, 5, shape, generator=gen,
                             device='cuda').to(dtype)

    widths = (1, 32, 40, 256, 320)
    n_exact = n_ordered = 0

    def hold_ordered(label, got, x, blk):
        nonlocal n_ordered
        if not torch.equal(got, ob.ordered_aggregate(x, blk)):
            raise AssertionError(f'{label}: the kernel differs from '
                                 f'ordered_aggregate')
        n_ordered += 1

    for blocks in _hub_blocks():
        B, M = blocks.inv_degree.shape[:2]
        for C in widths:
            for dt, gd in ((torch.float32, None), (BF16, 'bfloat16')):
                blk = blocks.replace(gather_dtype=gd)
                label = f'blocked B={B} M={M} C={C} {dt}'
                h = ints((B, M, C), dt)
                got = hold_equal(f'{label} exact',
                                 lambda: kb.aggregate(h, blk),
                                 lambda: ob.plain_aggregate(h, blk))
                hold_ordered(f'{label} exact', got, h, blk)
                n_exact += 1
                h = torch.randn((B, M, C), generator=gen,
                                device='cuda').to(dt)
                got = kb.aggregate(h, blk)
                if not torch.equal(got, kb.aggregate(h, blk)):
                    raise AssertionError(f'{label}: a repeat gave another '
                                         f'result')
                hold_ordered(label, got, h, blk)
                hold_close(label, got, ob.plain_aggregate(h, blk))
    args = dbp15k.parse_args(KG_ARGV + F32_ARGV)
    train_b, _, _ = dbp15k.synthetic_batches(args)
    sides = {s: GraphBatch.host(getattr(train_b, s)).to('cuda')
             for s in ('s', 't')}
    errs = {}
    for side, g in sides.items():
        for name, fwd, bwd in (('in', g.blocks_in, g.blocks_out),
                               ('out', g.blocks_out, g.blocks_in)):
            for C in widths:
                for dt, gd in ((torch.float32, None), (BF16, 'bfloat16')):
                    f_blk = fwd.replace(gather_dtype=gd)
                    b_blk = bwd.replace(gather_dtype=gd)
                    h = torch.randn((1, g.num_nodes, C), generator=gen,
                                    device='cuda').to(dt)
                    d_out = torch.randn((1, g.num_nodes, C), generator=gen,
                                        device='cuda')
                    rows = str(ob.operand_dtype(dt, C, gd)).replace(
                        'torch.', '')
                    for what, x, blk in (('forward', h, f_blk),
                                         ('backward', d_out, b_blk)):
                        label = (f'blocked {side} {name} C={C} {what} '
                                 f'{rows} rows')
                        got = kb.aggregate(x, blk)
                        if not torch.equal(got, kb.aggregate(x, blk)):
                            raise AssertionError(f'{label}: a repeat gave '
                                                 f'another result')
                        hold_ordered(label, got, x, blk)
                        err = hold_close(label, got,
                                         ob.plain_aggregate(x, blk))
                        key = (C, rows)
                        errs[key] = max(errs.get(key, 0.0), err)
    log(f'blocked_kernel: {n_ordered} cases bit-identical to '
        f'ordered_aggregate; {n_exact} exact cases bit-equal to the plain '
        f'version; the source and target KGs ({sides["s"].num_edges} / '
        f'{sides["t"].num_edges} edges, {sides["s"].blocks_in.src.shape[1]} '
        f'/ {sides["t"].blocks_in.src.shape[1]} blocks of 512) in both '
        f'directions, forward and backward, at C = {widths}, within rtol '
        f'1e-5 / atol 1e-5 x max|out| of the plain version, repeats '
        f'bit-identical; max |err| by (C, rows): {errs}')

    # Times on the source KG, incoming direction (ψ₁'s first aggregation).
    g = sides['s']
    n = g.num_nodes
    adj = torch.sparse_coo_tensor(
        torch.stack([g.receivers[0], g.senders[0]]),
        torch.ones(g.num_edges, device='cuda'), (n, n)).coalesce()
    all_edges = g.csr('senders', masked=False)
    real = g.csr('receivers')
    for key, (_, C, rows) in BLOCKED_ROWS.items():
        dt = BF16 if rows == 'bfloat16' else torch.float32
        blk = g.blocks_in.replace(
            gather_dtype='bfloat16' if dt == BF16 else None)
        h = torch.randn((1, n, C), generator=gen, device='cuda').to(dt)
        x = ob.operand(h, blk.gather_dtype)
        csr = adj.to(dt).to_sparse_csr()
        calls = {'kernel': lambda: kb.launch(x, blk),
                 'plain': lambda: ob.plain_aggregate(h, blk),
                 'library': lambda: torch.sparse.mm(csr, x[0]),
                 'replaced': lambda: scatter_to_nodes(
                     gather_nodes(h, g.senders, all_edges), g.receivers,
                     g.edge_mask, n, aggr='sum', segs=real)}
        try:
            calls['library']()
        except RuntimeError as e:   # the yardstick only
            log(f'blocked_kernel: torch.sparse.mm in {dt} not measured '
                f'({e!r})')
            del calls['library']
        got, src = timed(calls)
        flops, nbytes = _blocked_work(blk, C, x.element_size())
        b_ms, b_by = bound(flops, nbytes)
        plan = kb.launch_plan(n, C, x.element_size(), x.data_ptr())
        log(f'blocked_kernel: {key} (source KG, {g.num_edges} edges, C={C}, '
            f'{rows} rows; launch {plan}): bound {b_ms:.4f} ms ({b_by}: '
            f'{nbytes / 1e6:.2f} '
            f'MB at {PEAK_BYTES / 1e12} TB/s, {flops / 1e6:.1f} Mflop); ms '
            f'per call [{src}] / wall: '
            + ', '.join(f'{k} {v[0]:.4f} / {v[1]:.4f}' for k, v in got.items())
            + f'; kernel at {b_ms / got["kernel"][0]:.3f} of the bound, '
            f'{got["replaced"][0] / got["kernel"][0]:.2f}x faster than the '
            f'gather + segment path it replaces')
        res[key].update(
            name=key, route='cuda', source='dgmc_tpu_torch/csrc/blocked.cu',
            replaces='dgmc_tpu/ops/blocked.py:148 (XLA one-hot einsums; no '
                     'pallas_call)',
            max_abs_err=errs[(C, rows)], ms=got['kernel'][0],
            plain_ms=got['plain'][0], bound_ms=b_ms, bound_by=b_by,
            library_ms=got['library'][0] if 'library' in got else None,
            replaced_ms=got['replaced'][0], ms_source=src)

    # The hub batch: half of element 0's 20000 edges into node 3, one
    # lane group's serial sum; the yardstick is torch.sparse.mm of the
    # batch's block-diagonal adjacency.
    blk = _hub_blocks()[0]
    B, M = blk.inv_degree.shape[:2]
    deg = (blk.row_ptr[:, 1:] - blk.row_ptr[:, :-1]).reshape(-1)
    dst = torch.repeat_interleave(torch.arange(B * M, device='cuda'), deg)
    src = torch.cat([blk.row_src[b, :int(blk.row_ptr[b, -1])] + b * M
                     for b in range(B)]).long()
    csr = torch.sparse_coo_tensor(
        torch.stack([dst, src]), torch.ones(len(src), device='cuda'),
        (B * M, B * M)).coalesce().to_sparse_csr()
    for C in (256, 32):
        x = torch.randn((B, M, C), generator=gen, device='cuda')
        got, how = timed({'kernel': lambda: kb.launch(x, blk),
                          'library': lambda: torch.sparse.mm(
                              csr, x.reshape(B * M, C))})
        b_ms, _ = bound(*_blocked_work(blk, C, 4))
        log(f'blocked_kernel: hub batch (B={B}, M={M}, '
            f'{int(blk.mask.sum())} edges, {int(deg.max())} into one '
            f'node, C={C}, float32 rows): ms per call [{how}]: '
            f'kernel {got["kernel"][0]:.4f}, torch.sparse.mm '
            f'{got["library"][0]:.4f}; bound {b_ms:.4f} ms')


def _blocked_kernel_calls(gen):
    """``{name: call}`` of the blocked kernel's ``launch`` on the synthetic
    source KG's incoming tables at the widths of :data:`BLOCKED_ROWS`
    and on the hub batch (:func:`_hub_blocks`) at C = 256 and 32, float32
    rows, built by whichever tree is imported; each name carries the
    call's bound."""
    from dgmc_tpu_torch.experiments import dbp15k
    from dgmc_tpu_torch.ops import blocked as ob
    from dgmc_tpu_torch.ops.graph import GraphBatch
    from dgmc_tpu_torch.ops.kernels import blocked as kb
    train_b, _, _ = dbp15k.synthetic_batches(
        dbp15k.parse_args(KG_ARGV + F32_ARGV))
    g = GraphBatch.host(train_b.s).to('cuda')
    cases = [(key, g.blocks_in, C, rows)
             for key, (_, C, rows) in BLOCKED_ROWS.items()]
    cases += [(f'blocked hub C={C}', _hub_blocks()[0], C, 'float32')
              for C in (256, 32)]
    calls = {}
    for key, blocks, C, rows in cases:
        B, M = blocks.inv_degree.shape[:2]
        x = torch.randn((B, M, C), generator=gen).to(
            'cuda', getattr(torch, rows))
        try:
            b_ms, _ = bound(*_blocked_work(blocks, C, x.element_size()))
            label = f'{key} (bound {b_ms:.4f})'
        except ImportError:   # a tree before the kernels' work functions
            label = key
        calls[label] = functools.partial(kb.launch, x, blocks)
    return calls


def _kg_cli(argv, hook=None):
    """``dbp15k.main(argv)`` with its standard output captured and echoed
    → ``(state, stdout)``."""
    import io
    from dgmc_tpu_torch.experiments import dbp15k
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state = dbp15k.main(argv, hook=hook)
    out = buf.getvalue()
    for line in out.splitlines():
        log(f'  | {line}')
    return state, out


def phase_kg_tiers(res):
    """The KG path's other memory tiers at full width, each through
    ``dbp15k.main``:

    - ``--blocked_adjacency off``: the gather + segment branch, 3 phase-1
      epochs and 1 phase-2 epoch with its eval; no blocked launch, the
      other kernels at the KG path's counts, the losses finite and the
      phase-1 ones within 1e-4 relative of the blocked main path's first
      three (``kg_train``: same weights, draws and dropout masks; the two
      branches sum in other orders).
    - ``--stream_chunk 4096 --offload-corpus``: the search over 4 source
      chunks (one top-k launch each: 4 per step and eval, 8 in the offload
      pass), blocked off by ``auto``; 2 epochs (1 of phase 1); the pass
      prints ``equal=True``.
    - ``python -m dgmc_tpu_torch.ops.offload`` at its default sizes (2^23
      host rows of 16 channels against 2^17 targets, chunks of 2^15, ring
      depth 2): one top-k launch per chunk, the verified prefix equal;
      then a second pass over two slots (``devices=('cuda:0',
      'cuda:0')``, the round-robin one card can exercise) on the first
      :data:`OFFLOAD_SLOTS_ROWS` rows: indices bit-equal to the one-device
      ring's, ``devices: 2``.
    """
    from dgmc_tpu_torch.ops import offload
    from dgmc_tpu_torch.ops.kernels import dispatch
    base = KG_ARGV + F32_ARGV
    marks = []

    def hook(kind, epoch, out):
        marks.append((kind, epoch, dispatch.launch_counts(),
                      float(out['loss']) if kind == 'train' else None))
    dispatch.reset()
    t0 = time.perf_counter()
    _kg_cli(base + ['--blocked_adjacency', 'off', '--epochs', '4',
                    '--phase1_epochs', '3'], hook)
    counts = dispatch.launch_counts()
    losses = [m[3] for m in marks if m[0] == 'train']
    if not np.isfinite(losses).all():
        raise AssertionError(f'kg unblocked: non-finite losses {losses}')
    prev = {k: 0 for k in KG_KERNELS}
    for kind, epoch, cnt, _ in marks:
        w = KG_PER[('train' if kind == 'train' else 'eval',
                    1 if epoch <= 3 else 2)]
        w = tuple(0 if k == 'blocked' else v for k, v in zip(KG_KERNELS, w))
        got = tuple(cnt[k] - prev[k] for k in KG_KERNELS)
        if got != w:
            raise AssertionError(f'kg unblocked {kind} epoch {epoch}: '
                                 f'launches {got}, expected {w}')
        prev = cnt
    # The main path's first three epochs are the same phase-1 steps.
    ref = KG_LOSSES['f32'][:3]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses[:3], ref)]
    if max(rel) > 1e-4:
        raise AssertionError(f'kg: unblocked phase-1 losses {losses[:3]} '
                             f'differ from the blocked main path\'s {ref} by '
                             f'{rel}')
    log(f'kg_tiers: --blocked_adjacency off: 4 epochs (3 of phase 1) '
        f'through dbp15k.main in {time.perf_counter() - t0:.1f}s, launches '
        f'{dict((k, counts[k]) for k in KG_KERNELS)} (no blocked launch), '
        f'losses {losses}; phase-1 losses within {max(rel):.3g} relative of '
        f'the blocked main path\'s {ref}')

    marks = []
    dispatch.reset()
    t0 = time.perf_counter()
    _, out = _kg_cli(base + ['--stream_chunk', '4096', '--offload-corpus',
                             '--epochs', '2', '--phase1_epochs', '1'],
                     lambda kind, epoch, o: marks.append(
                         (kind, epoch, dispatch.launch_counts()['topk'])))
    counts = dispatch.launch_counts()
    per = [b[2] - a[2] for a, b in zip([(0, 0, 0)] + marks, marks)]
    pass_launches = counts['topk'] - marks[-1][2]
    if ('equal=True' not in out or counts['blocked'] or per != [4, 4, 4]
            or pass_launches != 8):
        raise AssertionError(f'kg streamed + offload: top-k launches per '
                             f'step {per}, in the offload pass '
                             f'{pass_launches}, blocked {counts["blocked"]}')
    log(f'kg_tiers: --stream_chunk 4096 --offload-corpus: 2 epochs in '
        f'{time.perf_counter() - t0:.1f}s, top-k launches per step and eval '
        f'{per} (4 source chunks), {pass_launches} in the offload pass (the '
        f'device-resident streamed search and the ring\'s), no blocked '
        f'launch; the pass printed equal=True')

    dispatch.reset()
    import io
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = offload.main([])
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    n = dispatch.launch_counts()['topk']
    want = rec['offload']['chunks'] + 1
    if rc or not rec['verified_equal'] or n != want:
        raise AssertionError(f'ops.offload: rc {rc}, {rec}, top-k launches '
                             f'{n} (expected {want})')
    log(f'kg_tiers: ops.offload at its defaults in '
        f'{time.perf_counter() - t0:.1f}s: {json.dumps(rec)}; top-k launches '
        f'{n} (one a chunk, one for the verified prefix)')
    _offload_two_slots()


#: The rows of ``kg_tiers``' second offload pass (2^21 of the default
#: corpus's 16 channels against its 2^17 targets, chunks of 2^15).
OFFLOAD_SLOTS_ROWS = 1 << 21


def _offload_two_slots():
    """``kg_tiers``' offload pass over two slots of one card against the
    one-device ring on the same inputs."""
    from dgmc_tpu_torch.ops import offload
    from dgmc_tpu_torch.ops.kernels import dispatch
    corpus = offload._synthetic_corpus(OFFLOAD_SLOTS_ROWS, 16, 8)
    rng = np.random.RandomState(9)
    h_t = torch.from_numpy(rng.randn(1, 1 << 17, 16).astype(np.float32))
    out = {}
    for name, kw in (('one', {'device': 'cuda:0'}),
                     ('two', {'devices': ('cuda:0', 'cuda:0')})):
        dispatch.reset()
        t0 = time.perf_counter()
        vals, idx, stats = offload.offloaded_streamed_topk(
            corpus, h_t, 10, 1 << 15, **kw)
        out[name] = (vals, idx, stats, time.perf_counter() - t0,
                     dispatch.launch_counts()['topk'])
    (v1, i1, s1, t1, n1), (v2, i2, s2, t2, n2) = out['one'], out['two']
    if not (torch.equal(i1, i2) and torch.equal(v1, v2)) or \
            s2.devices != 2 or s1.devices != 1 or n2 != s2.chunks:
        raise AssertionError(f'kg_tiers: two-slot ring: indices equal '
                             f'{torch.equal(i1, i2)}, stats {s2}, top-k '
                             f'launches {n2}')
    log(f'kg_tiers: the offload ring over two slots of one card '
        f'(devices=(\'cuda:0\', \'cuda:0\'): the round-robin of JAX\'s ring '
        f'on one physical GPU) at {OFFLOAD_SLOTS_ROWS} rows: indices and '
        f'values bit-equal to the one-device ring, stats {s2.to_json()} '
        f'({t2:.2f}s, {n2} top-k launches) against the one-device '
        f'{t1:.2f}s')


#: The routed sums' rows of the kernels line (``phase_union_route``): the
#: scaled projection over ``r_s``'s rows and the candidate gather's
#: backward, at the phase-2 training shape.
ROUTE_ROWS = ('corr_project', 'corr_gather_bwd')
#: The routed phase-2 step's launches per step (``KG_KERNELS`` as
#: ``KG_PER``'s phase-2 step, then the routed sums: a projection and an
#: ``o_t`` gather's backward per consensus step; ψ₁ is detached, so the
#: ``h_t`` gather has no backward).
ROUTE_KERNELS = KG_KERNELS + ROUTE_ROWS
ROUTE_PER = KG_PER[('train', 2)] + (10, 10)
ROUTE_STEPS = 20


def _route_exact_cases(gen):
    """The routed kernel on small exact cases (integer rows, quarter
    scales): a duplicate in every third row, a hub target, padded source
    rows; float32 rows at C = 1, 32 and 40, bf16 rows at C = 64 (read as
    bf16, the product rounded to bf16); scaled and not. Bit-identical to
    ``ordered_aggregate`` and bit-equal to the plain version; repeats
    bit-identical. Returns the number of cases."""
    from dgmc_tpu_torch.ops import blocked as ob
    from dgmc_tpu_torch.ops.corr_route import build_corr_route
    from dgmc_tpu_torch.ops.kernels import blocked as kb
    n = 0
    B, N_s, K, n_t = 2, 300, 6, 700
    idx = torch.randint(0, n_t, (B, N_s, K), generator=gen, device='cuda')
    idx[:, ::3, -1] = idx[:, ::3, 0]
    idx[0, 40:] = 3                               # a hub target
    route = build_corr_route(idx, n_t, rows=64, block_entries=128)
    S = torch.randint(-8, 9, (B, N_s, K), generator=gen,
                      device='cuda').float() / 4
    S[1, -50:] = 0                                # padded source rows
    for C, dt in ((1, torch.float32), (32, torch.float32),
                  (40, torch.float32), (64, BF16)):
        for which in ('src', 'ent'):
            M = N_s if which == 'src' else N_s * K
            x = torch.randint(-4, 5, (B, M, C), generator=gen,
                              device='cuda').to(dt)
            label = f'routed {which} C={C} {dt}'
            if which == 'src':
                got = hold_equal(label, lambda: kb.route_project(x, S, route),
                                 lambda: route.plain_sum(
                                     x, 'src', route.block_scale(S)))
                want = ob.ordered_aggregate(x, route.table('src'),
                                            route.row_scale(S, dt))
            else:
                got = hold_equal(label, lambda: kb.route_gather_bwd(x, route),
                                 lambda: route.plain_sum(x, 'ent'))
                want = ob.ordered_aggregate(x, route.table('ent'))
            if not torch.equal(got, want):
                raise AssertionError(f'{label}: the kernel differs from '
                                     f'ordered_aggregate')
            n += 1
    return n


def _route_sums(res, model, dev_b):
    """(a): the routed sums at the phase-2 training shape, on a real
    phase-2 shortlist (the model's own, negatives and ground truth in)."""
    from dgmc_tpu_torch.models.dgmc import draw_negatives, draw_noise
    from dgmc_tpu_torch.ops import blocked as ob
    from dgmc_tpu_torch.ops.corr_route import build_corr_route
    from dgmc_tpu_torch.ops.kernels import blocked as kb
    gen = torch.Generator(device='cuda').manual_seed(0)
    n_exact = _route_exact_cases(gen)
    g_s, g_t, y, y_mask = dev_b
    N_s, N_t = g_s.num_nodes, g_t.num_nodes
    probe = copy.deepcopy(model).train()
    probe.psi_1.dropout = 0.0
    with torch.no_grad():
        r_s = draw_noise(probe.num_steps, 1, N_s, probe.psi_2.in_channels,
                         seed=1, device='cuda')
        neg = draw_negatives(torch.tensor([N_t], device='cuda'), N_s,
                             probe.k, seed=1)
        _, S_L = probe(g_s, g_t, y=y, y_mask=y_mask, num_steps=1,
                       detach=True, r_s=r_s[:1], negatives=neg)
    S_idx, S = S_L.idx, S_L.val.float()
    K = S_idx.shape[-1]
    t0 = time.perf_counter()
    route = build_corr_route(S_idx, N_t)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    deg = route.row_ptr[0, 1:] - route.row_ptr[0, :-1]
    max_deg, hub = int(deg.max()), int(deg.argmax())
    R = model.psi_2.in_channels
    x_s = r_s[0]                                       # [1, N_s, R]
    g = torch.randn((1, N_s * K, R), generator=gen, device='cuda')
    dst = S_idx.reshape(-1).long()
    rows = torch.arange(N_s * K, device='cuda')
    ones = torch.ones(N_s * K, device='cuda')
    cases = {
        'corr_project': dict(
            kernel=lambda: kb.route_project(x_s, S, route),
            ordered=lambda: ob.ordered_aggregate(
                x_s, route.table('src'), route.row_scale(S)),
            plain=lambda: route.plain_sum(x_s, 'src', route.block_scale(S)),
            launch=functools.partial(kb.launch_route, x_s, route.row_ptr,
                                     route.row_src, route.row_scale(S)),
            adj=torch.sparse_coo_tensor(torch.stack([dst, rows // K]),
                                        S.reshape(-1), (N_t, N_s)),
            table=x_s[0], work=kb.project_work(x_s, S, route)),
        'corr_gather_bwd': dict(
            kernel=lambda: kb.route_gather_bwd(g, route),
            ordered=lambda: ob.ordered_aggregate(g, route.table('ent')),
            plain=lambda: route.plain_sum(g, 'ent'),
            launch=functools.partial(kb.launch_route, g, route.row_ptr,
                                     route.row_ent),
            adj=torch.sparse_coo_tensor(torch.stack([dst, rows]), ones,
                                        (N_t, N_s * K)),
            table=g[0], work=kb.gather_bwd_work(g, route))}
    for key, c in cases.items():
        got = c['kernel']()
        if not torch.equal(got, c['kernel']()):
            raise AssertionError(f'{key}: a repeat gave another result')
        if not torch.equal(got, c['ordered']()):
            raise AssertionError(f'{key}: the kernel differs from the '
                                 f'scaled ordered_aggregate')
        err = hold_close(key, got, c['plain']())
        csr = c['adj'].coalesce().to_sparse_csr()
        table = c['table']
        got_t, src = timed({'kernel': c['launch'], 'plain': c['plain'],
                            'library': lambda: torch.sparse.mm(csr, table)})
        b_ms, b_by = work_bound(c['work'])
        log(f'union_route: (a) {key} at [1, {N_s}, {K}] over {N_t} targets, '
            f'C={R}, float32 rows: bit-identical to ordered_aggregate, '
            f'within rtol 1e-5 / atol 1e-5 x max|out| of the plain version '
            f'(max |err| {err:.3g}); bound {b_ms:.4f} ms ({b_by}: '
            f'{c["work"]["bytes"] / 1e6:.2f} MB, {c["work"]["flops"] / 1e6:.1f}'
            f' Mflop); ms per call [{src}] / wall: '
            + ', '.join(f'{k} {v[0]:.4f} / {v[1]:.4f}'
                        for k, v in got_t.items())
            + f'; kernel at {b_ms / got_t["kernel"][0]:.3f} of the bound')
        res[key].update(
            name=key, route='cuda', source='dgmc_tpu_torch/csrc/blocked.cu',
            replaces=('dgmc_tpu/ops/corr_route.py:124 (sparse_project: XLA '
                      'one-hot einsums, dgmc_tpu/ops/blocked.py:148; no '
                      'pallas_call)' if key == 'corr_project' else
                      'dgmc_tpu/ops/corr_route.py:170 (sparse_gather\'s '
                      'backward: XLA one-hot einsums, dgmc_tpu/ops/'
                      'blocked.py:148; no pallas_call)'),
            max_abs_err=err, ms=got_t['kernel'][0],
            plain_ms=got_t['plain'][0], bound_ms=b_ms, bound_by=b_by,
            library_ms=got_t['library'][0], ms_source=src)
    log(f'union_route: (a) {n_exact} exact cases bit-equal to the plain '
        f'version and bit-identical to ordered_aggregate; the route built '
        f'in {build_ms:.3f} ms (host clock, synchronized); the shortlist\'s '
        f'largest target in-degree {max_deg} (target {hub}; '
        f'{int((deg > 0).sum())} of {N_t} targets hit, mean '
        f'{float(deg.float().mean()):.2f})')


def _route_losses(model, batch, policy):
    """(b): loss and gradients of one phase-2 forward and backward, routed
    and not, from the same weights, shortlist, noise and negatives (ψ₁'s
    dropout off), against each other: float32 within the CPU test's
    tolerance (loss rtol 1e-5, each gradient rtol 1e-4 / atol 1e-4 x its
    largest entry, the two zero analytically below 1e-6), bf16 within
    1e-2 relative for the loss and 2e-2 of each gradient's norm (the two
    zero analytically below 1e-2 of the largest gradient entry)."""
    from dgmc_tpu_torch.models.dgmc import draw_negatives, draw_noise
    from dgmc_tpu_torch.train.steps import batch_to_device
    from dgmc_tpu_torch.ops.topk import chunked_topk
    base = copy.deepcopy(model).cpu()
    base.psi_1.dropout = 0.0
    g_s, g_t = batch_to_device(batch, 'cuda')[:2]
    N_s, N_t = g_s.num_nodes, g_t.num_nodes
    probe = copy.deepcopy(base).cuda().eval()
    with torch.no_grad():
        S_idx = chunked_topk(probe.psi_1(g_s.x, g_s).to(torch.float32),
                             probe.psi_1(g_t.x, g_t).to(torch.float32),
                             probe.k).cpu()
    r_s = draw_noise(probe.num_steps, 1, N_s, probe.psi_2.in_channels,
                     seed=3, device='cuda')
    neg = draw_negatives(torch.tensor([N_t], device='cuda'), N_s, probe.k,
                         seed=3)
    got = {}
    for routed in (False, True):
        m = copy.deepcopy(base)
        m.route_sparse = routed
        got[routed] = _kg_loss_and_grads(m, batch, S_idx, r_s, neg, 'cuda',
                                         torch.float32)
    (l0, g0), (l1, g1) = got[False], got[True]
    worst = 0.0
    # Zero analytically: rounding noise only, below 1e-6 in float32 and
    # below 1e-2 of the largest gradient entry under bf16.
    zero_tol = 1e-6 if policy == 'f32' else 1e-2 * max(
        float(w.abs().max()) for w in g0.values())
    for name, w in g0.items():
        d = g1[name]
        if name in ZERO_GRAD:
            if max(float(d.abs().max()), float(w.abs().max())) > zero_tol:
                raise AssertionError(f'union_route {policy}: {name} '
                                     f'gradient not ~0')
            continue
        if policy == 'f32':
            if not torch.allclose(d, w, rtol=1e-4,
                                  atol=1e-4 * float(w.abs().max())):
                raise AssertionError(f'union_route {policy}: gradient {name} '
                                     f'routed against default differs by '
                                     f'{float((d - w).abs().max())}')
            worst = max(worst, float((d - w).abs().max()
                                     / max(float(w.abs().max()), 1e-30)))
        else:
            rel = float((d - w).norm() / max(float(w.norm()), 1e-30))
            if rel > 2e-2:
                raise AssertionError(f'union_route {policy}: gradient {name} '
                                     f'routed against default: relative '
                                     f'norm error {rel}')
            worst = max(worst, rel)
    rel_loss = abs(l1 - l0) / abs(l0)
    if rel_loss > (1e-5 if policy == 'f32' else 1e-2):
        raise AssertionError(f'union_route {policy}: routed loss {l1} against '
                             f'default {l0}')
    return l0, l1, worst


def _median_step_ms(run, n):
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), min(times), max(times)


def _route_step(policy, res_counts):
    """(b) under ``policy``: the captured routed phase-2 step against the
    eager one (5 steps at the CLI's seeds, outputs, then parameters and
    Adam state bit-identical; launches per step ``ROUTE_PER``), loss and
    gradients against the default path (:func:`_route_losses`), and the
    median of ``ROUTE_STEPS`` synchronized captured steps beside the
    default path's, in turns."""
    from dgmc_tpu_torch.experiments import dbp15k
    from dgmc_tpu_torch.ops.kernels import dispatch
    from dgmc_tpu_torch.train.state import create_train_state
    from dgmc_tpu_torch.train.steps import batch_to_device, make_train_step
    args = dbp15k.parse_args(KG_ARGV + ['--precision', policy])
    train_b, _, in_dim = dbp15k.synthetic_batches(args)
    model = dbp15k.build(args, in_dim)
    l0, l1, worst = _route_losses(model, train_b, policy)
    log(f'union_route: (b) {policy}: one phase-2 forward and backward, '
        f'routed against default from the same weights, shortlist, noise '
        f'and negatives: loss {l1!r} against {l0!r}, worst gradient '
        f'{"error / max|grad|" if policy == "f32" else "relative norm error"}'
        f' {worst:.3g}')
    dev_b = batch_to_device(train_b, 'cuda')
    routed = copy.deepcopy(model)
    routed.route_sparse = True
    models = {jit: copy.deepcopy(routed).cuda() for jit in (False, True)}
    states = {jit: create_train_state(m, args.lr)
              for jit, m in models.items()}
    steps_ = {jit: make_train_step(m, num_steps=args.num_steps, detach=True,
                                   jit=jit) for jit, m in models.items()}
    runs = []
    for e in range(args.phase1_epochs + 1, args.phase1_epochs + 6):
        seed = dbp15k.noise_seed(args.seed, 0, e)
        runs.append((f'phase2 epoch {e}', {jit: functools.partial(
            lambda jit, s: steps_[jit](states[jit], dev_b, s)[1], jit, seed)
            for jit in (False, True)}))
    # This slice's main path: the counters at 0 just before, read just
    # after.
    dispatch.reset()
    _both(f'union_route {policy}', ROUTE_KERNELS, runs,
          want=lambda name: ROUTE_PER)
    counts = dispatch.launch_counts()
    for k in ROUTE_ROWS:
        res_counts[k] = res_counts.get(k, 0) + counts[k]
    _hold_states(f'union_route {policy}', models, states)
    d = dispatch.decisions()
    for k in ROUTE_ROWS:
        if d[k]['path'] != 'kernel' or d[k]['dtype'] != 'float32':
            raise AssertionError(f'union_route {policy}: {k} {d[k]}')
    default = kg_step(policy)
    default()
    seeds = itertools.count(100)

    def routed_run():
        return steps_[True](states[True], dev_b, next(seeds))
    half = ROUTE_STEPS // 2
    times = {'default': [], 'routed': []}
    for name in ('default', 'routed', 'routed', 'default'):
        run = default if name == 'default' else routed_run
        med, lo, hi = _median_step_ms(run, half)
        times[name].append((med, lo, hi))
    summary = {k: (statistics.median([t[0] for t in v]),
                   min(t[1] for t in v), max(t[2] for t in v))
               for k, v in times.items()}
    log(f'union_route: (b) {policy}: the captured routed phase-2 step '
        f'bit-identical to the eager one over 5 steps (outputs, then '
        f'parameters and Adam state), launches per step '
        f'{dict(zip(ROUTE_KERNELS, ROUTE_PER))}; rows in float32 (ψ₂\'s '
        f'R = 32 widened); median ms of {ROUTE_STEPS} synchronized captured '
        f'steps (min, max), in turns: routed '
        f'{summary["routed"][0]:.3f} ({summary["routed"][1]:.3f}, '
        f'{summary["routed"][2]:.3f}), default {summary["default"][0]:.3f} '
        f'({summary["default"][1]:.3f}, {summary["default"][2]:.3f})')
    return model, dev_b, args


def _batch_pair_part(model, dev_b, args):
    """(c): ``batch_pair`` in {'psi_1', 'psi_2', True} on the DBP15K model:
    the eval forward (dropout off) against the two-call model on the same
    weights and noise, within JAX's test tolerance (rtol 5e-4, atol 5e-5)
    where the shortlists agree (rows that differ are near ties, at most
    0.1%); then one captured training step each (after its capture), ψ₁'s
    dropout as the CLI has it, beside the two-call model's."""
    from dgmc_tpu_torch.models.dgmc import draw_noise
    from dgmc_tpu_torch.ops.kernels import dispatch
    from dgmc_tpu_torch.train.state import create_train_state
    from dgmc_tpu_torch.train.steps import make_train_step
    g_s, g_t = dev_b[:2]
    r_s = draw_noise(args.num_steps, 1, g_s.num_nodes, args.rnd_dim, seed=5,
                     device='cuda')
    base = copy.deepcopy(model).cuda().eval()
    with torch.no_grad():
        _, want = base(g_s, g_t, r_s=r_s)
    step_ms = {}
    for bp in (None, 'psi_1', 'psi_2', True):
        m = copy.deepcopy(model).cuda()
        m.batch_pair = bp
        if bp is not None:
            with torch.no_grad():
                _, got = m.eval()(g_s, g_t, r_s=r_s)
            same = (got.idx == want.idx).all(-1)[0]
            n_diff = int((~same).sum())
            if n_diff > 1e-3 * g_s.num_nodes:
                raise AssertionError(f'union_route batch_pair={bp!r}: '
                                     f'{n_diff} shortlists differ')
            a, b = got.val[0][same], want.val[0][same]
            if not torch.allclose(a, b, rtol=5e-4, atol=5e-5):
                raise AssertionError(f'union_route batch_pair={bp!r}: S_L '
                                     f'differs by {float((a - b).abs().max())}')
            log(f'union_route: (c) batch_pair={bp!r}: S_L within rtol 5e-4 '
                f'/ atol 5e-5 of the two-call model (max |diff| '
                f'{float((a - b).abs().max()):.3g}) on the {int(same.sum())} '
                f'rows whose shortlist agrees, {n_diff} near-tie rows '
                f'differ')
        m.train()
        state = create_train_state(m, args.lr)
        step = make_train_step(m, num_steps=args.num_steps, detach=True)
        before = dispatch.launch_counts()
        step(state, dev_b, 1)                          # the capture
        torch.cuda.synchronize()
        after = dispatch.launch_counts()
        med, lo, hi = _median_step_ms(lambda: step(state, dev_b, 2), 3)
        step_ms[bp] = med
        log(f'union_route: (c) batch_pair={bp!r}: a captured phase-2 '
            f'training step {med:.3f} ms (median of 3, {lo:.3f}-{hi:.3f}); '
            f'launches of the first step '
            f'{ {k: after[k] - before[k] for k in KG_KERNELS} }')
    return step_ms


def _refusals(model, args):
    """(d): the refusals on CUDA tensors."""
    import dataclasses
    from dgmc_tpu_torch.experiments import dbp15k
    from dgmc_tpu_torch.train.steps import batch_to_device
    unblocked = dbp15k.parse_args(KG_ARGV + F32_ARGV
                                  + ['--blocked_adjacency', 'off'])
    train_u, _, in_dim = dbp15k.synthetic_batches(unblocked)
    g_s, g_t = batch_to_device(train_u, 'cuda')[:2]
    cases = []
    m = copy.deepcopy(model).cuda().eval()
    m.batch_pair = True
    cases.append(('an unblocked side', m, (g_s, g_t), 'cannot be stacked'))
    train_b, _, _ = dbp15k.synthetic_batches(args)
    b_s, b_t = batch_to_device(train_b, 'cuda')[:2]
    bn = bn_kg_model(args, in_dim).cuda().eval()
    bn.batch_pair = 'psi_1'
    cases.append(('batch norm', bn, (b_s, b_t), 'BatchNorm'))
    narrow = dataclasses.replace(b_t, x=b_t.x[..., :-1], _memo={})
    m = copy.deepcopy(model).cuda().eval()
    m.batch_pair = 'psi_1'
    cases.append(('a width mismatch', m, (b_s, narrow), 'widths differ'))
    for label, m, graphs, match in cases:
        try:
            with torch.no_grad():
                m(*graphs)
        except ValueError as e:
            if not re.search(match, str(e)):
                raise AssertionError(f'union_route (d) {label}: {e}')
            log(f'union_route: (d) {label}: ValueError ({str(e)[:60]}...)')
        else:
            raise AssertionError(f'union_route (d) {label}: no refusal')


def phase_union_route(res):
    """This slice's paths on the DBP15K model at the JAX CLI's widths
    (RelCNN ψ₁ 300→256, ψ₂ 32→32, k = 10, 10 steps, blocked) on the
    synthetic 15000 / 20000 entities, in-process:

    (a) the routed sums (``ops/corr_route.py`` through ``csrc/blocked.cu``'s
        routed entry) at the phase-2 training shape, ``S_idx [1, 15000,
        20]`` over 20000 targets from the model's own phase-2 shortlist:
        the scaled projection at C = 32 and the gather's backward at
        R = 32, bit-identical to the scaled ``ordered_aggregate`` and
        within rtol / atol 1e-5 of JAX's one-hot plain version; exact
        small cases (hub, duplicates, padded rows, bf16 rows) bit-equal;
        each timed beside its bound, the plain version and
        ``torch.sparse.mm`` of the ``[n_t, N_s]`` (or ``[n_t, N_s K]``)
        matrix; the largest target in-degree;
    (b) the captured phase-2 training step with ``route_sparse=True``,
        float32 and bf16: captured bit-identical to eager, launches per
        step (the counters at 0 before, read after: the routed rows'
        ``launches``), loss and gradients against the default path from
        the same weights, noise and negatives, the median of 20 steps
        beside the default path's;
    (c) ``batch_pair`` in {'psi_1', 'psi_2', True}: the forward against the
        two-call model (rtol 5e-4, atol 5e-5), one captured training step
        each;
    (d) the refusals on CUDA tensors: an unblocked side, batch norm, a
        width mismatch.
    """
    counts = {}
    model = None
    for policy in ('f32', 'bf16'):
        m, dev_b, args = _route_step(policy, counts)
        if policy == 'f32':
            model, f32_b, f32_args = m, dev_b, args
    for k in ROUTE_ROWS:
        res[k]['launches'] = counts.get(k, 0)
    log(f'union_route: (b) launches of the routed sums over both policies\' '
        f'5 eager and 5 captured steps: {counts}')
    _route_sums(res, model.cuda(), f32_b)
    _batch_pair_part(model, f32_b, f32_args)
    _refusals(model, f32_args)


#: The resume phase's schedule: 6 epochs, 3 of phase 1, a checkpoint every
#: 2 (the guard's run every epoch, so that the step after its rollback is
#: on disk).
RESUME_ARGV = ['--epochs', '6', '--phase1_epochs', '3', '--ckpt_every', '2']


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _eval_lines(out):
    """The printed eval lines without their seconds per epoch."""
    return [re.sub(r' \([0-9.]+s/epoch\)', '', line)
            for line in out.splitlines() if re.match(r'\d{3}: Loss', line)]


def _hold_checkpoints(label, a, b):
    """Two checkpoint payloads bit-identical: every model tensor, every
    Adam moment and count, the steps."""
    if (a['step'], a['state_step']) != (b['step'], b['state_step']):
        raise AssertionError(f'{label}: steps {a["step"]}/{a["state_step"]} '
                             f'against {b["step"]}/{b["state_step"]}')
    want = dict(a['model'])
    got = dict(b['model'])
    for i, st in a['optimizer']['state'].items():
        for k, v in st.items():
            want[f'adam {i} {k}'] = v
            got[f'adam {i} {k}'] = b['optimizer']['state'][i][k]
    _hold_identical(label, want, got, 'the two checkpoints')
    return len(want)


def _kg_marks(label, marks, phase1_epochs, first=1):
    """The KG path's launches per step and eval from the hook's marks
    (``(kind, epoch, counts)``, the counters set to 0 before the run) at
    ``KG_PER``'s counts."""
    prev = {k: 0 for k in KG_KERNELS}
    for kind, epoch, cnt in marks:
        w = KG_PER[('train' if kind == 'train' else 'eval',
                    1 if epoch <= phase1_epochs else 2)]
        got = tuple(cnt[k] - prev[k] for k in KG_KERNELS)
        if got != w:
            raise AssertionError(f'{label} {kind} epoch {epoch}: launches '
                                 f'{got}, expected {w} {KG_KERNELS}')
        prev = cnt
    return prev


def phase_resume(smi_line, beside=None):
    """Checkpoints, resume and the guard at the DBP15K width (float32,
    captured), each run through ``dbp15k`` with ``RESUME_ARGV``
    (``beside``, if given, is called as (b) starts and returns a future:
    host work of a later phase that runs while (b) waits on its
    processes, waited for when they are done):

    (a) an uninterrupted run, ``--ckpt_dir A`` (in this process, the
    launch counters set to 0 before it: ``KG_PER``'s counts a step);
    (b) the same run crashed and resumed in two processes of
    ``python -m dgmc_tpu_torch.experiments.dbp15k``, ``--ckpt_dir B
    --ckpt_every 1 --inject-fault ckpt-corrupt@3 --inject-fault
    sigkill@5`` (the saves asynchronous, the CLI's default; the fault
    waits for step 3's commit): the first dies by SIGKILL with step 4's
    write in flight (B holds its ``.tmp-4-*`` directory and no step 4),
    the second removes it, falls back past step 3 (its manifest mismatch)
    to step 2, resumes at epoch 3 and finishes; B's step-6 checkpoint
    equals A's bit for bit (every model tensor and Adam moment and count)
    and so does its last eval line;
    (c) ``--ckpt_dir C --ckpt_every 1 --guard-bad-steps 1 --inject-fault
    nan-grads@5``: epoch 5 reports ``bad_step`` with ``skip_count`` 1, the
    rollback restores the epoch-4 snapshot (C's step 5, saved after it,
    equals A's step-4 parameters bit for bit, its Adam state zeros),
    epoch 6's loss is finite, C's step 4 equals A's (the guarded captured
    step changes no bit of a clean update); then the guarded phase-2 step
    eager and captured from C's step 4, on the bad epoch 5 and the clean
    epoch 6: outputs, parameters, Adam state and counters bit-identical,
    launches equal; an asynchronous save of that state, then at once a
    replay that writes it in place: the restore equals the state at the
    save bit for bit; the device ops and device time of one replay of the
    captured phase-2 step unguarded, with the guard alone and with the
    fault armed too, printed (the profiler must record each, and each
    adds ops); then ``--ckpt_dir D --guard-bad-steps 3`` with no fault
    over a copy of A's step 2: it resumes at epoch 3, runs both phases
    (each leaves some parameters without a gradient) with no bad step,
    prints A's eval lines with the counters at 0, and its steps 4 and 6
    equal A's bit for bit;
    (d) ``python -m dgmc_tpu_torch.serve --ckpt_dir A --num-queries 4``
    twice (the corpus cache missed, then hit; the answers identical; the
    restored ψ₁'s ``params_fingerprint`` not the seeded model's), and
    ``--init-missing`` on an empty directory answering exactly as the
    seeded CLI without ``--ckpt_dir``.

    Prints each save's seconds and bytes, the restore's seconds and the
    seconds from the restore's start to the end of the first step run
    after it, beside the card's name and power limit."""
    import io
    import tempfile
    from dgmc_tpu_torch.experiments import dbp15k
    from dgmc_tpu_torch.ops.kernels import dispatch
    from dgmc_tpu_torch.serve import cli as serve_cli
    from dgmc_tpu_torch.serve.corpus import params_fingerprint
    from dgmc_tpu_torch.train.checkpoint import Checkpointer, STATE_FILE
    from dgmc_tpu_torch.train.state import (create_train_state,
                                            with_guard_counters)
    from dgmc_tpu_torch.train.steps import batch_to_device, make_train_step
    import dgmc_tpu_torch
    base = KG_ARGV + F32_ARGV + RESUME_ARGV
    root = os.path.dirname(os.path.dirname(os.path.abspath(
        dgmc_tpu_torch.__file__)))

    def payload(d, step):
        return torch.load(os.path.join(d, str(step), STATE_FILE),
                          map_location='cpu', weights_only=True)

    def marked_run(argv):
        marks, outs = [], {}

        def hook(kind, epoch, out):
            marks.append((kind, epoch, dispatch.launch_counts()))
            outs[(kind, epoch)] = out
        dispatch.reset()
        _, out = _kg_cli(argv, hook)
        gc.collect()
        torch.cuda.empty_cache()
        return marks, outs, out

    with tempfile.TemporaryDirectory() as tmp:
        A, B, C = (os.path.join(tmp, n) for n in 'ABC')
        # (a) uninterrupted
        t0 = time.perf_counter()
        marks, _, out_a = marked_run(base + ['--ckpt_dir', A,
                                             '--metrics_log', A + '.jsonl'])
        counts = _kg_marks('resume (a)', marks, 3)
        RESUME_A.update(payload=payload(A, 6),
                        eval=_eval_lines(out_a)[-1])
        saves = [(e['step'], round(e['save_s'], 4), round(e['write_s'], 4),
                  e['save_bytes'])
                 for e in _read_jsonl(A + '.jsonl')
                 if e.get('event') == 'checkpoint']
        if [s[0] for s in saves] != [2, 4, 6] or \
                Checkpointer(A).all_steps() != [2, 4, 6]:
            raise AssertionError(f'resume (a): saves {saves}')
        log(f'resume (a): 6 epochs (3 of phase 1) through dbp15k.main in '
            f'{time.perf_counter() - t0:.1f}s, launches '
            f'{dict((k, counts[k]) for k in KG_KERNELS)} at KG_PER\'s counts '
            f'a step; asynchronous saves (step, seconds the loop was '
            f'blocked, the background write\'s seconds, bytes) {saves}, '
            f'beside the synchronous save\'s 0.037-0.118 s (PRs 1-16) on '
            f'{smi_line}')

        # (b) crashed and resumed, in two processes
        cmd = [sys.executable, '-m', 'dgmc_tpu_torch.experiments.dbp15k',
               *base, '--ckpt_dir', B, '--metrics_log', B + '.jsonl',
               '--ckpt_every', '1', '--inject-fault', 'ckpt-corrupt@3',
               '--inject-fault', 'sigkill@5']
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root] + [p for p in [os.environ.get('PYTHONPATH')] if p]))
        runs = []
        side = beside() if beside is not None else None
        for _ in range(2):
            t0 = time.perf_counter()
            r = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                               text=True, timeout=900)
            runs.append(r)
            for line in (r.stdout + r.stderr).splitlines():
                log(f'  | {line}')
            log(f'resume (b): process {len(runs)} exited {r.returncode} '
                f'after {time.perf_counter() - t0:.1f}s')
            if len(runs) == 1:
                # Killed before epoch 5, right after step 4's save
                # returned: its write was in flight.
                left = sorted(os.listdir(B))
                if '4' in left or not any(n.startswith('.tmp-4-')
                                          for n in left):
                    raise AssertionError(f'resume (b): after the SIGKILL B '
                                         f'holds {left}: step 4\'s write was '
                                         f'not in flight')
                log(f'resume (b): after the SIGKILL B holds {left}: step '
                    f'4\'s write was in flight')
        if side is not None:
            t0 = time.perf_counter()
            concurrent.futures.wait([side])
            log(f'resume (b): waited {time.perf_counter() - t0:.2f}s for '
                f'the work beside it')
        if runs[0].returncode != -9:
            raise AssertionError(f'resume (b): the first process exited '
                                 f'{runs[0].returncode}, not by SIGKILL')
        if runs[1].returncode != 0 or \
                'at epoch 2. (latest step 3 was unrestorable)' \
                not in runs[1].stdout or \
                'step 3 failed verification' not in runs[1].stderr or \
                any(n.startswith('.tmp-') for n in os.listdir(B)):
            raise AssertionError('resume (b): the second process did not '
                                 'fall back past step 3 and finish')
        n = _hold_checkpoints('resume (b): B step 6 against A step 6',
                              payload(A, 6), payload(B, 6))
        la, lb = _eval_lines(out_a), _eval_lines(runs[1].stdout)
        if la[-1] != lb[-1] or lb != la[-len(lb):]:
            raise AssertionError(f'resume (b): eval lines {lb} against {la}')
        ev = {e.get('event'): e for e in _read_jsonl(B + '.jsonl')}
        log(f'resume (b): SIGKILL at epoch 5 with step 4\'s write in '
            f'flight, then resumed at epoch 3 from the last committed good '
            f'step (2: step 3 corrupt): step 6 bit-identical to A\'s ({n} '
            f'model '
            f'tensors and Adam tensors), last eval line equal '
            f'({lb[-1]!r}); restore {ev["resume"]["restore_s"]:.4f} s, '
            f'restore to the end of the first step '
            f'{ev["resume_first_step"]["seconds"]:.3f} s (the phase-1 '
            f'graph\'s capture included) on {smi_line}')

        # (c) the guard inside the graph
        t0 = time.perf_counter()
        marks, outs, out_c = marked_run(
            base + ['--ckpt_dir', C, '--ckpt_every', '1',
                    '--guard-bad-steps', '1', '--inject-fault',
                    'nan-grads@5', '--metrics_log', C + '.jsonl'])
        _kg_marks('resume (c)', marks, 3)
        bad = {e: bool(o['bad_step']) for (k, e), o in outs.items()
               if k == 'train'}
        if bad != {e: e == 5 for e in range(1, 7)} or \
                int(outs[('train', 5)]['skip_count']) != 1 or \
                not np.isfinite(float(outs[('train', 6)]['loss'])):
            raise AssertionError(f'resume (c): bad steps {bad}')
        rb = [e for e in _read_jsonl(C + '.jsonl')
              if e.get('event') == 'rollback']
        if [(e['step'], e['rollback_to']) for e in rb] != [(5, 4)]:
            raise AssertionError(f'resume (c): rollbacks {rb}')
        _hold_checkpoints('resume (c): C step 4 against A step 4',
                          payload(A, 4), payload(C, 4))
        c5, a4 = payload(C, 5), payload(A, 4)
        _hold_identical('resume (c): the rollback against A step 4',
                        a4['model'], c5['model'], 'the two checkpoints')
        if any(v.any() for st in c5['optimizer']['state'].values()
               for v in st.values()) or c5['guard']['skip_count'] != 1:
            raise AssertionError('resume (c): the rollback did not reset '
                                 'the optimizer or lost the ledger')
        log(f'resume (c): nan-grads@5 skipped in the graph (bad_step at '
            f'epoch 5 only, skip_count 1), rolled back to the epoch-4 '
            f'snapshot (bit-identical to A\'s step 4, fresh Adam state), '
            f'epoch 6 loss {float(outs[("train", 6)]["loss"]):.4f}; the '
            f'guarded steps 1-4 bit-identical to the unguarded A\'s; '
            f'{time.perf_counter() - t0:.1f}s')

        # (c) eager against captured, and the device ops per replay
        args = dbp15k.parse_args(base)
        train_b, _, in_dim = dbp15k.synthetic_batches(args)
        train_dev = batch_to_device(train_b, 'cuda')
        models, states = {}, {}
        for jit in (False, True):
            models[jit] = dbp15k.build(args, in_dim).cuda()
            states[jit] = with_guard_counters(create_train_state(
                models[jit], args.lr))
            Checkpointer(C).restore(models[jit], states[jit], step=4)
        guarded = {jit: make_train_step(models[jit],
                                        num_steps=args.num_steps,
                                        detach=True, guard=True,
                                        fault_nan_step=5, jit=jit)
                   for jit in (False, True)}
        runs_ = [(f'guarded phase 2 epoch {e}', {jit: functools.partial(
            lambda jit, e: guarded[jit](
                states[jit], train_dev,
                dbp15k.noise_seed(args.seed, 0, e))[1], jit, e)
            for jit in (False, True)}) for e in (5, 6)]
        _both('resume (c)', KG_KERNELS, runs_,
              want=lambda name: KG_PER[('train', 2)])
        n = _hold_states('resume (c) guarded', models, states)
        for name in ('skip_count', 'consec_bad'):
            if not torch.equal(getattr(states[False], name),
                               getattr(states[True], name)):
                raise AssertionError(f'resume (c): {name} differs')
        # An asynchronous save, then at once a replay that writes the
        # parameters and Adam's state in place: the step restores as it
        # was at the save.
        E = os.path.join(tmp, 'E')
        ck = Checkpointer(E)
        want = {k: v.detach().clone()
                for k, v in models[True].state_dict().items()}
        for i, st in enumerate(states[True].optimizer.state.values()):
            for k, v in st.items():
                want[f'adam {i} {k}'] = v.detach().clone()
        t0 = time.perf_counter()
        ck.save(1, models[True], states[True])
        blocking = time.perf_counter() - t0
        guarded[True](states[True], train_dev,
                      dbp15k.noise_seed(args.seed, 0, 7))
        ck.close()
        back_model = dbp15k.build(args, in_dim).cuda()
        back = with_guard_counters(create_train_state(back_model, args.lr))
        Checkpointer(E).restore(back_model, back)
        got = dict(back_model.state_dict())
        for i, st in enumerate(back.optimizer.state.values()):
            for k, v in st.items():
                got[f'adam {i} {k}'] = v
        moved = sum(not torch.equal(v, models[True].state_dict()[k])
                    for k, v in want.items() if not k.startswith('adam'))
        _hold_identical('resume (c): the asynchronous save against the '
                        'state at the save', want, got, 'the restore')
        if not moved:
            raise AssertionError('resume (c): the replay after the save '
                                 'changed no parameter')
        log(f'resume (c): an asynchronous save of the guarded state '
            f'({ck.last_save["seconds"]:.4f}s blocking, {blocking:.4f}s on '
            f'the caller\'s clock, write {ck.last_save["write_s"]:.4f}s, '
            f'{ck.last_save["bytes"]} bytes), then a replay that moved '
            f'{moved} parameter tensors in place: the restore equals the '
            f'state at the save bit for bit ({len(want)} tensors) on '
            f'{smi_line}')
        del back_model, back
        plain_model = dbp15k.build(args, in_dim).cuda()
        plain_state = create_train_state(plain_model, args.lr)
        Checkpointer(C).restore(plain_model, plain_state, step=4)
        plain = make_train_step(plain_model, num_steps=args.num_steps,
                                detach=True)
        guard_only = make_train_step(models[True], num_steps=args.num_steps,
                                     detach=True, guard=True)
        seed = dbp15k.noise_seed(args.seed, 0, 6)
        ops = {}
        for label, fn in (
                ('unguarded', lambda: plain(plain_state, train_dev, seed)),
                ('guard alone', lambda: guard_only(states[True], train_dev,
                                                   seed)),
                ('guard and nan-grads armed', lambda: guarded[True](
                    states[True], train_dev, seed))):
            for _ in range(3):   # the profiler now and then records none
                rows, _ = _profiled(fn)
                if rows:
                    break
            else:
                raise AssertionError(f'resume (c): the profiler recorded no '
                                     f'device op of the {label} replay')
            ops[label] = (sum(r[2] for r in rows),
                          sum(r[0] for r in rows) / 1e3)
        counts_ = [v[0] for v in ops.values()]
        if not counts_[0] < counts_[1] < counts_[2]:
            raise AssertionError(f'resume (c): device ops per replay {ops}')
        log(f'resume (c): the guarded phase-2 step eager and captured from '
            f'C\'s step 4, epoch 5 (bad, frozen) and 6 (clean): outputs and '
            f'{n} parameters and Adam tensors, counters bit-identical, '
            f'launches as KG_PER\'s; one replay each (device ops, device '
            f'ms under the profiler): ' + ', '.join(
                f'{k} {v[0]} ops {v[1]:.3f} ms' for k, v in ops.items())
            + f' on {smi_line}')
        del models, states, guarded, guard_only, runs_, plain, plain_model
        del plain_state
        gc.collect()
        torch.cuda.empty_cache()

        # (c) the guard alone, no fault armed, from A's step 2: both phases
        # leave parameters without a gradient, which the guard takes as
        # zeros; the run changes no bit of A's.
        D = os.path.join(tmp, 'D')
        os.makedirs(os.path.join(D, 'manifests'))
        shutil.copytree(os.path.join(A, '2'), os.path.join(D, '2'))
        shutil.copy(os.path.join(A, 'manifests', '2.json'),
                    os.path.join(D, 'manifests'))
        t0 = time.perf_counter()
        marks, outs, out_d = marked_run(base + ['--ckpt_dir', D,
                                                '--guard-bad-steps', '3'])
        counts = _kg_marks('resume (c) guard alone', marks, 3)
        ld = _eval_lines(out_d)
        want = [f'{line}, skipped_steps: 0, consec_bad: 0'
                for line in _eval_lines(out_a)[-len(ld):]]
        if 'at epoch 2.' not in out_d or not ld or ld != want or any(
                bool(o['bad_step']) for (k, _), o in outs.items()
                if k == 'train'):
            raise AssertionError(f'resume (c) guard alone: eval lines {ld} '
                                 f'against {want}')
        for step in (4, 6):
            _hold_checkpoints(f'resume (c) guard alone: D step {step} '
                              f'against A', payload(A, step), payload(D, step))
        log(f'resume (c): --guard-bad-steps 3 with no fault, resumed from '
            f'A\'s step 2 (epochs 3-6, both phases): launches '
            f'{dict((k, counts[k]) for k in KG_KERNELS)} at KG_PER\'s counts '
            f'a step, no bad step, eval lines A\'s with the counters at 0, '
            f'steps 4 and 6 bit-identical to A\'s; '
            f'{time.perf_counter() - t0:.1f}s')

        # (d) serving the trained checkpoint
        def serve(argv):
            out, err = io.StringIO(), io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out), \
                    contextlib.redirect_stderr(err):
                rc = serve_cli.main(['--num-queries', '4'] + argv)
            answers = [json.loads(line) for line in
                       out.getvalue().splitlines()]
            for a in answers:
                a.pop('latency_ms')
            cache = re.search(r'\(cache ([^)]*)\)', err.getvalue())
            gc.collect()
            torch.cuda.empty_cache()
            if rc or len(answers) != 4 or cache is None:
                raise AssertionError(f'resume (d): serve {argv}: rc {rc}, '
                                     f'{err.getvalue()[-2000:]}')
            return answers, cache.group(1), time.perf_counter() - t0

        first = serve(['--ckpt_dir', A])
        second = serve(['--ckpt_dir', A])
        if not (first[1].startswith('miss') and second[1] == 'hit'
                and first[0] == second[0]):
            raise AssertionError(f'resume (d): cache {first[1]} then '
                                 f'{second[1]}, answers equal '
                                 f'{first[0] == second[0]}')
        with open(os.path.join(A, 'corpus_cache', 'manifest.json')) as f:
            meta = json.load(f)
        seeded_fp = params_fingerprint(serve_cli.dbp15k_model(0).psi_1)
        if meta['checkpoint_step'] != 6 or \
                meta['params_fingerprint'] == seeded_fp:
            raise AssertionError(f'resume (d): cache meta {meta}')
        init = serve(['--ckpt_dir', os.path.join(tmp, 'empty'),
                      '--init-missing'])
        seeded = serve([])
        if init[0] != seeded[0] or init[0] == first[0]:
            raise AssertionError('resume (d): --init-missing answers differ '
                                 'from the seeded CLI\'s')
        log(f'resume (d): serve --ckpt_dir A (step 6): cache {first[1]} '
            f'({first[2]:.1f}s) then {second[2]:.1f}s with cache hit, '
            f'4 answers identical, restored psi_1 fingerprint '
            f'{meta["params_fingerprint"][:12]} (seeded {seeded_fp[:12]}); '
            f'--init-missing on an empty directory answers as the seeded '
            f'CLI')


#: The keypoint fixture (``phase_keypoints``): PascalVOC instances per
#: category in the train and val lists, WILLOW items per category, the
#: images' size where PIL writes them, PascalPF items per category, and
#: the keypoints each category's test pairs are sampled until
#: (``--test_samples``; the JAX CLI's 1000 would sample the fixture's 15
#: test instances a category about 7 times over, each a batch of 512
#: pairs whose 1024 graphs the host triangulates anew; 100 took 27
#: batches an evaluation, 0.37 s each on the card's host, where one
#: pass a category is 20).
KP_VOC = (60, 15)
KP_WILLOW_ITEMS = 24
KP_IMAGE = (180, 240)
KP_PF_ITEMS = 4
KP_TEST_SAMPLES = 40
#: The rows of this slice's shapes in the JSON line: the key its
#: launches are filed under on the keypoint main paths (``KP_MAIN``):
#: (kernel, O or R, D, dtype).
KP_ROWS = {
    'consensus_fwd@kp': ('consensus_fwd', 128, None, 'float32'),
    'consensus_fwd_bf16@kp': ('consensus_fwd', 128, None, 'bfloat16'),
    **{f'spline_route_{k}{tag}@kp,O={O}{",D=1" if D == 1 else ""}':
       (f'spline_route_{k}', O, D, dtype)
       for k in ('fwd', 'bwd') for O in (256, 128)
       for D, dtype, tag in ((2, 'float32', ''), (1, 'float32', ''),
                             (2, 'bfloat16', '_bf16'))}}
#: ``{(kernel, O or R, D, dtype): launches}`` on the keypoint main paths
#: (``pascal`` under both policies and isotropic, ``willow``).
KP_MAIN = {}


@contextlib.contextmanager
def keypoint_launches(tally):
    """Within the block, file every launch of the routing kernels under
    ``(kernel, O, D, dtype)`` and of the dense consensus under
    ``('consensus_fwd', R, None, dtype)`` in ``tally`` (a
    :class:`Tally`, so that replays count): the wrappers' counters read
    around each call of the autograd functions that call them."""
    from dgmc_tpu_torch.ops.kernels import consensus, spline
    fn, cons = spline._RouteAggregate, consensus._ConsensusUpdate
    fwd, bwd, cfwd = fn.forward, fn.backward, cons.forward

    def counted(key, wrapper, call, *args):
        before = wrapper.launches
        out = call(*args)
        tally.add(key, wrapper.launches - before)
        return out

    def dims(basis):
        return basis.shape[-1].bit_length() - 1

    fn.forward = staticmethod(lambda ctx, t, basis, routing: counted(
        ('spline_route_fwd', t.shape[-1], dims(basis), str(t.dtype)[6:]),
        spline.route_fwd, fwd, ctx, t, basis, routing))
    fn.backward = staticmethod(lambda ctx, g: counted(
        ('spline_route_bwd', g.shape[-1], dims(ctx.saved_tensors[1]),
         str(g.dtype)[6:]), spline.route_d_t, bwd, ctx, g))
    cons.forward = staticmethod(lambda ctx, o_s, *rest: counted(
        ('consensus_fwd', o_s.shape[-1], None, str(o_s.dtype)[6:]),
        consensus.consensus_fwd, cfwd, ctx, o_s, *rest))
    try:
        yield
    finally:
        fn.forward, fn.backward = staticmethod(fwd), staticmethod(bwd)
        cons.forward = staticmethod(cfwd)


def _kp_batches(root):
    """The first training batch of the ``pascal`` loader (512 pairs) under
    Cartesian (D = 2) and Distance (D = 1) pseudo-coordinates, and the
    padded node and edge counts: node features are not read
    (``vgg_weights='none'``)."""
    from dgmc_tpu_torch.datasets import PascalVOCKeypoints, VGG16Features
    from dgmc_tpu_torch.datasets.pascal_voc import CATEGORIES
    from dgmc_tpu_torch.experiments import pascal
    from dgmc_tpu_torch.utils.data import (ConcatDataset, PairLoader,
                                           ValidPairDataset, graph_limits)
    none = VGG16Features('none')
    out = {}
    for D in (2, 1):
        tr = pascal.keypoint_transform(D == 1)
        sets = {t: [PascalVOCKeypoints(root, c, train=t, transform=tr,
                                       features=none) for c in CATEGORIES]
                for t in (True, False)}
        N, E = graph_limits(sets[True] + sets[False])
        loader = PairLoader(ConcatDataset(
            [ValidPairDataset(d, d, sample=True) for d in sets[True]]), 512,
            num_nodes=N, num_edges=E)
        out[D] = next(iter(loader))
    return out, N, E


def _kp_kernels(res, kp_batches):
    """(a) The dense consensus at ``[512, N, N]``, R = 128 (its limit), and
    the routing kernels at O = 256 and 128, D = 2 and 1, on this slice's
    batches (``kp_batches``, :func:`_kp_batches`' result), each policy's
    variant against its plain version on the card (exact inputs
    bit-equal; float32 within :func:`hold_close`, bf16 outputs within
    :func:`hold_ulp`), timed beside the plain version and
    ``torch.sparse.mm`` with its bound."""
    from dgmc_tpu_torch.models.spline import spline_routing
    from dgmc_tpu_torch.ops.graph import GraphBatch
    from dgmc_tpu_torch.ops.kernels import dispatch
    from dgmc_tpu_torch.ops.kernels.consensus import (R_MAX, consensus_fwd,
                                                      plain_consensus)
    from dgmc_tpu_torch.ops.kernels.spline import (plain_route_aggregate,
                                                   plain_route_d_t,
                                                   route_d_t, route_fwd)
    gen = torch.Generator().manual_seed(15)
    batches, N, E = kp_batches
    B, R = 512, R_MAX
    log(f'keypoints (a): the fixture pads to N = {N} nodes, E = {E} edges; '
        f'consensus at [{B}, {N}, {N}] R = {R}')

    def cons_case(ints):
        def draw(*shape, scale=1.0):
            if ints:
                return torch.randint(-2, 3, shape, generator=gen).float()
            return scale * torch.randn(*shape, generator=gen)
        return [x.cuda() for x in (
            draw(B, N, R), draw(B, N, R), draw(R, R, scale=R ** -0.5),
            draw(R, scale=0.1), draw(R, 1, scale=R ** -0.5),
            draw(1, scale=0.1))]

    for dtype, key, peak in ((torch.float32, 'consensus_fwd@kp',
                              PEAK_F32_FLOPS),
                             (BF16, 'consensus_fwd_bf16@kp',
                              PEAK_BF16_FLOPS)):
        a = [x.to(dtype) for x in cons_case(True)]
        hold_equal(f'keypoints consensus {dtype} exact',
                   lambda: consensus_fwd(*a), lambda: plain_consensus(*a))
        if dispatch.decisions()['consensus_fwd']['dtype'] != str(dtype)[6:]:
            raise AssertionError('keypoints: the consensus variant of '
                                 f'{dtype} did not run')
        a = [x.to(dtype) for x in cons_case(False)]
        out = consensus_fwd(*a)
        torch.cuda.synchronize()
        err = hold_close(f'keypoints consensus {dtype}', out,
                         plain_consensus(*a))
        if not torch.equal(out, consensus_fwd(*a)):
            raise AssertionError('keypoints consensus: a repeat differs')
        got, src = timed({'kernel': lambda: consensus_fwd(*a),
                          'plain': lambda: plain_consensus(*a)})
        b_ms, b_by = work_bound(
            consensus_work(B, N, N, R, a[0].element_size()), peak)
        log(f'keypoints (a): consensus {str(dtype)[6:]} at [{B}, {N}, {N}] '
            f'R={R}: exact bit-equal, random within tolerance (max |err| '
            f'{err:.3g}); bound {b_ms:.4f} ms ({b_by}); ms per call [{src}] '
            f'/ wall: ' + ', '.join(f'{k} {v[0]:.4f} / {v[1]:.4f}'
                                    for k, v in got.items())
            + f'; by launch: '
            f'{fmt_split(launch_split(lambda: consensus_fwd(*a)))}')
        res[key].update(
            name=f'{key.split("@")[0]}@{B}x{N}x{N},R={R}', route='cuda',
            source='dgmc_tpu_torch/csrc/consensus.cu',
            replaces='dgmc_tpu/ops/pallas/consensus.py:49',
            max_abs_err=err, ms=got['kernel'][0], plain_ms=got['plain'][0],
            bound_ms=b_ms, bound_by=b_by, library_ms=None, ms_source=src)

    for D in (2, 1):
        graph = GraphBatch.from_numpy(batches[D].s, 'cuda')
        basis, routing = spline_routing(graph, 5)
        if basis.shape[-1] != 2 ** D:
            raise AssertionError(f'keypoints: D = {D} routed '
                                 f'{basis.shape[-1]} slots an edge')
        M = routing.num_rows
        for dtype in (torch.float32, BF16):
            tag = '' if dtype == torch.float32 else '_bf16'
            # Exact inputs at the slice's sizes, then this batch's routing.
            t, g, eb, er = _spline_exact(gen, B, N, E, 128, 0.2, D=D)
            t, g = t.to(dtype), g.to(dtype)
            hold_equal(f'keypoints spline fwd D={D} {dtype} exact',
                       lambda: route_fwd(t, eb, er),
                       lambda: plain_route_aggregate(t, eb, er))
            hold_equal(f'keypoints spline d_t D={D} {dtype} exact',
                       lambda: route_d_t(g, eb, er),
                       lambda: plain_route_d_t(g, eb, er))
            if dispatch.decisions()['spline_route_bwd']['dtype'] != \
                    str(dtype)[6:]:
                raise AssertionError('keypoints: the spline variant of '
                                     f'{dtype} did not run')
            hold = hold_close if dtype == torch.float32 else hold_ulp
            for O in (256, 128):
                t = torch.randn(B, M, O, generator=gen).cuda().to(dtype)
                g = torch.randn(B, N, O, generator=gen).cuda().to(dtype)
                out = route_fwd(t, basis, routing)
                torch.cuda.synchronize()
                err_f = hold(f'keypoints spline fwd D={D} O={O}', out,
                             plain_route_aggregate(t, basis, routing))
                err_b = hold(f'keypoints spline d_t D={D} O={O}',
                             route_d_t(g, basis, routing),
                             plain_route_d_t(g, basis, routing))
                if not torch.equal(out, route_fwd(t, basis, routing)):
                    raise AssertionError('keypoints spline: a repeat '
                                         'differs')
                calls = {'fwd': lambda: route_fwd(t, basis, routing),
                         'fwd plain': lambda: plain_route_aggregate(
                             t, basis, routing),
                         'd_t': lambda: route_d_t(g, basis, routing),
                         'd_t plain': lambda: plain_route_d_t(g, basis,
                                                              routing)}
                try:   # the yardstick, where cuSPARSE takes the dtype
                    Rm = _routing_matrix(basis, routing).to(dtype)
                    RT = _routing_matrix(basis, routing,
                                         transpose=True).to(dtype)
                    t2, g2 = t.reshape(B * M, O), g.reshape(B * N, O)
                    torch.sparse.mm(Rm, t2), torch.sparse.mm(RT, g2)
                    calls.update({
                        'fwd sparse.mm': lambda: torch.sparse.mm(Rm, t2),
                        'd_t sparse.mm': lambda: torch.sparse.mm(RT, g2)})
                except RuntimeError as e:
                    log(f'keypoints (a): torch.sparse.mm in {dtype} not '
                        f'available: {str(e)[:120]}')
                got, src = timed(calls)
                peak = PEAK_F32_FLOPS if dtype == torch.float32 \
                    else PEAK_BF16_FLOPS
                (fb, fby), (bb, bby) = _spline_work(
                    basis, routing, O, t.element_size(), peak)
                log(f'keypoints (a): spline {str(dtype)[6:]} D={D} O={O} '
                    f'[{B}, {M}, {O}]: exact bit-equal, random within '
                    f'tolerance (max |err| fwd {err_f:.3g}, d_t '
                    f'{err_b:.3g}); bound fwd {fb:.4f} ms ({fby}), d_t '
                    f'{bb:.4f} ms ({bby}); ms per call [{src}] / wall: '
                    + ', '.join(f'{k} {v[0]:.4f} / {v[1]:.4f}'
                                for k, v in got.items()))
                # No call can beat the least time its work takes: a time
                # below it means the profiler missed part of that call's
                # kernels (seen for cuSPARSE's), so it is no time.
                low = [k for k, v in got.items()
                       if v[0] < (fb if k.startswith('fwd') else bb)]
                if low:
                    log(f'keypoints (a): spline {str(dtype)[6:]} D={D} '
                        f'O={O}: {low} read below the bound [{src}]: not '
                        f'a time (part of the work went unrecorded); their '
                        f'CUDA-event times stand in')
                    got.update({k: (got[k][1], got[k][1]) for k in low})
                suffix = f'@kp,O={O}{",D=1" if D == 1 else ""}'
                for k, line, b_ms, b_by, err in (
                        ('fwd', 72, fb, fby, err_f),
                        ('bwd', 96, bb, bby, err_b)):
                    key = f'spline_route_{k}{tag}{suffix}'
                    name = 'fwd' if k == 'fwd' else 'd_t'
                    row = {'name': f'spline_route_{k}{tag}@{B}x{M}x{O},'
                                   f'D={D}',
                           'route': 'cuda',
                           'source': 'dgmc_tpu_torch/csrc/spline.cu',
                           'replaces': f'dgmc_tpu/ops/pallas/spline.py:'
                                       f'{line}',
                           'max_abs_err': err, 'ms': got[name][0],
                           'plain_ms': got[f'{name} plain'][0],
                           'bound_ms': b_ms, 'bound_by': b_by,
                           'library_ms': (got[f'{name} sparse.mm'][0]
                                          if f'{name} sparse.mm' in got
                                          else None),
                           'ms_source': src}
                    if key in res:
                        res[key].update(row)


def _kp_extractor():
    """(b) ``VGG16Features('random')`` on the card against the CPU on
    random images at crop sizes: the resize within one uint8 level, the
    features of one prepared image within rtol 1e-4 / atol 1e-4 x
    max|out|, from the image within 2e-3 x max|out| (the resize's level
    steps); one call timed."""
    from dgmc_tpu_torch.datasets import VGG16Features
    gpu = VGG16Features('random', device='cuda')
    cpu = VGG16Features('random', device='cpu')
    rng = np.random.RandomState(15)
    worst = {'levels': 0.0, 'share': 0.0, 'same': 0.0, 'image': 0.0}
    for h, w in ((97, 131), (160, 213), (60, 75)):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        kps = np.stack([rng.rand(15) * (w - 1), rng.rand(15) * (h - 1)], 1)
        with torch.no_grad():
            x_gpu, x_cpu = gpu.prepare(img).cpu(), cpu.prepare(img)
            levels = (255 * (x_gpu - x_cpu)).abs().round()
            if levels.max() > 1:
                raise AssertionError(f'extractor: the card\'s resize is '
                                     f'{levels.max()} levels off the CPU\'s')
            coords = torch.from_numpy(np.clip(kps / [w - 1, h - 1], 0, 1)
                                      .astype(np.float32))
            a = gpu.extract(x_cpu.cuda(), coords.cuda()).cpu()
            b = cpu.extract(x_cpu, coords)
        scale = float(b.abs().max())
        if not torch.allclose(a, b, rtol=1e-4, atol=1e-4 * scale):
            raise AssertionError(f'extractor: card and CPU features of one '
                                 f'image differ by {(a - b).abs().max()}')
        fa, fb = gpu(img, kps), cpu(img, kps)
        e2e = float(np.abs(fa - fb).max()) / float(np.abs(fb).max())
        if e2e > 2e-3:
            raise AssertionError(f'extractor: from the image, card and CPU '
                                 f'differ by {e2e} x max|out|')
        worst = {'levels': max(worst['levels'], float(levels.max())),
                 'share': max(worst['share'],
                              float((levels > 0).float().mean())),
                 'same': max(worst['same'],
                             float((a - b).abs().max()) / scale),
                 'image': max(worst['image'], e2e)}
    prepared = gpu.prepare(img)
    coords = coords.cuda()
    ms = cuda_ms(lambda: gpu(img, kps))
    dev = device_ms(lambda: gpu.extract(prepared, coords))
    log(f'keypoints (b): VGG16Features(random) on the card against the CPU '
        f'at 3 crop sizes: resize within {worst["levels"]:.0f} level '
        f'({100 * worst["share"]:.3f}% of values off), one prepared image '
        f'within {worst["same"]:.2e} x max|out|, from the image within '
        f'{worst["image"]:.2e} x max|out|; one call (256 x 256, 15 '
        f'keypoints, host to host) {ms:.3f} ms wall, the conv stack and '
        f'sampling {dev if dev is None else round(dev, 4)} ms device')


@contextlib.contextmanager
def _last_step(module):
    """Within the block, record the last call of every train step that
    ``module.make_train_step`` makes; yields ``run()``, which calls it
    again (a replay, once the step is captured) with the same state,
    batch and seed, for a profile after the CLI has returned."""
    make = module.make_train_step
    last = {}

    def recording(*a, **kw):
        step = make(*a, **kw)

        @functools.wraps(step)     # its .jit too
        def recorded(*args):
            last['call'] = (step, args)
            return step(*args)

        return recorded

    def run():
        step, args = last['call']
        return step(*args)

    module.make_train_step = recording
    try:
        yield run
    finally:
        module.make_train_step = make


def _kp_run(label, main, argv, policy, tally, hook=None):
    """One keypoint CLI ``main(argv)`` with the launch counters at 0 just
    before and read just after (those at this slice's shapes also filed
    in :data:`KP_MAIN` through ``tally``, unless it is None): every train
    step (``'train'`` /
    ``'pretrain'``) launches :data:`PER_TRAIN_STEP`, every eval batch
    :data:`PER_EVAL_BATCH`; the dispatch ledger shows every kernel in the
    policy's dtype; finite losses. Returns ``(losses, main's result)``,
    ``losses`` a list of ``(kind, [loss of each step])``, one an epoch (a
    run's epoch for ``willow``)."""
    from dgmc_tpu_torch.ops.kernels import dispatch
    dtype = 'bfloat16' if policy == 'bf16' else 'float32'
    marks, losses = [], []

    def mark(kind, index, out):
        if hook is not None:
            hook(kind, index, out)
        if kind not in ('train', 'pretrain', 'eval', 'real_eval'):
            return
        torch.cuda.synchronize()
        marks.append((kind, time.perf_counter(), dispatch.launch_counts()))
        if kind in ('train', 'pretrain'):
            if (index[-1] if isinstance(index, tuple) else index) == 0:
                losses.append((kind, []))
            losses[-1][1].append(float(out['loss']))

    torch.cuda.reset_peak_memory_stats()
    with (keypoint_launches(tally) if tally is not None
          else contextlib.nullcontext()):
        dispatch.reset()
        marks.append(('start', time.perf_counter(),
                      dispatch.launch_counts()))
        result = main(argv, hook=mark)
    # The next run's reset sets the tally's counters back to 0 too.
    for key, n in (tally.counts().items() if tally is not None else ()):
        KP_MAIN[key] = KP_MAIN.get(key, 0) + n
    decisions = dispatch.decisions()
    peak = torch.cuda.max_memory_allocated()
    for prev, cur in zip(marks, marks[1:]):
        want = (PER_EVAL_BATCH if cur[0] in ('eval', 'real_eval')
                else PER_TRAIN_STEP)
        got = _deltas(prev[2], cur[2])
        if got != want:
            raise AssertionError(f'{label}: {cur[0]} launches {got}, '
                                 f'expected {want}')
    for name in TRAIN_KERNELS:
        d = decisions[name]
        want = 'float32' if name in F32_ALWAYS else dtype
        if (d['path'] != 'kernel' or d['counts']['plain']
                or set(d['dtypes']) != {f'kernel:{want}'}):
            raise AssertionError(f'{label}: {name}: dispatch {d}')
    _hold_native_collation(label, decisions)
    flat = [v for _, vs in losses for v in vs]
    if not flat or not np.isfinite(flat).all():
        raise AssertionError(f'{label}: losses {losses}')
    step_ms = [1e3 * (b[1] - a[1]) for a, b in zip(marks, marks[1:])
               if b[0] in ('train', 'pretrain') and a[0] == b[0]]
    n = collections.Counter(m[0] for m in marks[1:])
    log(f'{label}: {dict(n)} steps and eval batches, each with the '
        f'formula\'s launches ({"/".join(map(str, PER_TRAIN_STEP))} a train '
        f'step, {"/".join(map(str, PER_EVAL_BATCH))} an eval batch: route '
        f'fwd / d_t / consensus / records / draw), every kernel in {dtype}; '
        f'mean loss by epoch '
        + ', '.join(f'{k} {np.mean(v):.4f}' for k, v in losses)
        + (f'; step ms (synchronized, host clock, a new batch each, the '
           f'capture left out): median {statistics.median(step_ms):.3f}, '
           f'min {min(step_ms):.3f}, max {max(step_ms):.3f}'
           if step_ms else '')
        + f'; max_memory_allocated {peak / 2**30:.3f} GiB')
    return losses, result


def phase_keypoints(res, prepared=None, beside=None):
    """The keypoint experiments (PascalVOC and WILLOW) on the card, on a
    fixture tree written by :func:`_kp_prepare` (here, or beforehand in
    the future ``prepared``; :mod:`dgmc_tpu_torch.datasets.fixtures`:
    ``KP_VOC`` instances per category, 6-20 keypoint names each, a
    visible subset per instance; ``KP_WILLOW_ITEMS`` WILLOW items per
    category; images where PIL imports, else none, so that the zero
    images feed the VGG stack): (a) :func:`_kp_kernels`; (b)
    :func:`_kp_extractor`; (c) ``pascal.main`` at the JAX CLI's widths,
    2 epochs, ``--test_samples KP_TEST_SAMPLES``, bf16 then ``--f32``: the
    launches of the formula, the loss falls, then one replayed train step
    profiled with its peak memory; (d) ``--isotropic --f32``, 1 epoch
    (D = 1 in the trainer); (e)
    ``willow.main`` at its widths, ``--pre_epochs 1 --epochs 1 --runs
    2``: run 2's first replayed step bit-identical to an eager step from
    the snapshot; (f) ``pascal_pf.main --data_root`` on a PascalPF
    fixture, 1 epoch: one captured eval graph per category size, every
    pair evaluated. Launches at this slice's shapes go to
    :data:`KP_MAIN`. ``beside`` is called after (b): work that may share
    the card with (c)-(f), whose checks are launches and equalities
    (:func:`elastic_launch`)."""
    from dgmc_tpu_torch.experiments import pascal
    prep = prepared.result() if prepared is not None else _kp_prepare()
    pil = prep['pil']
    try:
        log(f'keypoints: PIL {"imports" if pil else "does not import"} '
            f'here: the fixture {"has" if pil else "has no"} images '
            f'({KP_IMAGE[0]} x {KP_IMAGE[1]}, JPEG for PascalVOC, PNG for '
            f'WILLOW); {KP_VOC} PascalVOC instances a category (train, '
            f'val), {KP_WILLOW_ITEMS} WILLOW items, {KP_PF_ITEMS} PascalPF '
            f'items; written in {prep["written_s"]:.1f}s, (a)\'s batches '
            f'in {prep["batches_s"]:.1f}s'
            f'{" beside the resume phase" if prepared is not None else ""}; '
            f'--test_samples {KP_TEST_SAMPLES}')
        voc, wil, pf = prep['voc'], prep['wil'], prep['pf']
        _kp_kernels(res, prep['batches'])
        _kp_extractor()
        if beside is not None:
            beside()
        tally = Tally('keypoints')
        cut = ['--data_root', voc, '--test_samples', str(KP_TEST_SAMPLES)]
        for policy in ('bf16', 'f32'):
            with _last_step(pascal) as last:
                losses, _ = _kp_run(
                    f'keypoints (c) pascal {policy}', pascal.main,
                    cut + ['--epochs', '2', '--precision', policy], policy,
                    tally)
            by_epoch = [np.mean(v) for k, v in losses if k == 'train']
            if len(by_epoch) != 2 or not by_epoch[1] < by_epoch[0]:
                raise AssertionError(f'keypoints (c) {policy}: the loss did '
                                     f'not fall: {by_epoch}')
            _step_profile(last, f'keypoints (c) pascal {policy}: one '
                          f'replayed train step')
            del last
        _kp_run('keypoints (d) pascal --isotropic f32', pascal.main,
                cut + ['--epochs', '1', '--isotropic', '--f32'], 'f32',
                tally)
        _kp_isotropic_counts(prep['batches'])
        _kp_willow(voc, wil, tally)
        _kp_pascal_pf(pf)
    finally:
        shutil.rmtree(prep['tmp'], ignore_errors=True)


def _kp_isotropic_counts(kp_batches):
    """(d)'s count: the cost account of ``pascal``'s train step under the
    bf16 policy with ``--isotropic`` (D = 1: two knots an edge) on the
    loader's first batch, each dense kernel at its formula x launches
    (:func:`_hold_dense_counts`)."""
    from dgmc_tpu_torch.experiments import pascal
    from dgmc_tpu_torch.obs.cost import cost_summary
    from dgmc_tpu_torch.train.state import create_train_state
    from dgmc_tpu_torch.train.steps import make_train_step
    batch = kp_batches[0][1]
    args = pascal.parse_args(['--isotropic', '--precision', 'bf16'])
    model = pascal.build_model(args, np.shape(batch.s['x'])[-1]).cuda()
    state = create_train_state(model, learning_rate=args.lr)
    summary = cost_summary(make_train_step(model, loss_on_s0=True,
                                           jit=False), state, batch, 0)
    _hold_dense_counts('keypoints (d) pascal --isotropic bf16 cost',
                       summary['kernels'], model, batch, 1)
    del model, state
    gc.collect()
    torch.cuda.empty_cache()


def _kp_prepare():
    """The keypoint phase's host work that needs no card: the fixture tree
    in a new temporary directory and (a)'s two training batches
    (:func:`_kp_batches`) → ``{tmp, voc, wil, pf, pil, written_s,
    batches, batches_s}``."""
    import tempfile
    from dgmc_tpu_torch.datasets.fixtures import (write_pascal_pf,
                                                  write_voc, write_willow)
    try:
        import PIL.Image  # noqa: F401
        pil = True
    except ImportError:
        pil = False
    tmp = tempfile.mkdtemp(prefix='dgmc_keypoints_')
    try:
        t0 = time.perf_counter()
        size = KP_IMAGE if pil else None
        voc = write_voc(os.path.join(tmp, 'voc'), seed=0, train=KP_VOC[0],
                        val=KP_VOC[1], image_size=size)
        wil = write_willow(os.path.join(tmp, 'willow'), seed=1,
                           items=KP_WILLOW_ITEMS, image_size=size)
        pf = write_pascal_pf(os.path.join(tmp, 'pf'), seed=2,
                             items=KP_PF_ITEMS)
        t1 = time.perf_counter()
        batches = _kp_batches(voc)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return {'tmp': tmp, 'voc': voc, 'wil': wil, 'pf': pf, 'pil': pil,
            'written_s': t1 - t0, 'batches': batches,
            'batches_s': time.perf_counter() - t1}


def _kp_willow(voc, wil, tally):
    """(e) ``willow.main`` at its widths: the CLI's run 2 first replayed
    step against an eager step (``jit=False``) from the snapshot on the
    same batch and seed, outputs and parameters bit-identical."""
    from dgmc_tpu_torch.experiments import pascal, willow
    from dgmc_tpu_torch.train.state import create_train_state, restore_params
    from dgmc_tpu_torch.train.steps import make_train_step
    argv = ['--voc_root', voc, '--willow_root', wil,
            '--pre_epochs', '1', '--epochs', '1', '--runs', '2']
    seen = {}

    def hook(kind, index, out):
        if kind == 'snapshot':
            seen.update(out)
        elif kind == 'train' and index == (2, 1, 0):
            seen['out'] = _clone(out)
            seen['after'] = {k: v.clone() for k, v in
                             seen['model'].state_dict().items()}

    loaders = willow.run_loader
    kept = {}

    def run_loader(args, datasets, run, num_nodes, num_edges):
        kept.update(args=args, datasets=datasets,
                    limits=(num_nodes, num_edges))
        return loaders(args, datasets, run, num_nodes, num_edges)

    willow.run_loader = run_loader
    try:
        _, accs = _kp_run('keypoints (e) willow bf16', willow.main, argv,
                             'bf16', tally, hook=hook)
    finally:
        willow.run_loader = loaders
    if accs.shape != (2, 5) or not np.isfinite(accs).all():
        raise AssertionError(f'keypoints (e): accuracies {accs}')
    args = kept['args']
    model = pascal.build_model(args, 1024).cuda()
    state = create_train_state(model, learning_rate=args.lr)
    restore_params(state, model, seen['params'])
    batch = next(iter(loaders(args, kept['datasets'], 2, *kept['limits'])))
    _, out = make_train_step(model, loss_on_s0=True, jit=False)(
        state, batch, willow.noise_seed(args.seed, 0, 2, 1, 0))
    torch.cuda.synchronize()
    _hold_identical('keypoints (e) run 2 step 1', _clone(out), seen['out'],
                    'the eager step from the snapshot and the replay')
    _hold_identical('keypoints (e) run 2 step 1 parameters',
                    {k: v for k, v in model.state_dict().items()},
                    seen['after'],
                    'the eager step from the snapshot and the replay')
    log(f'keypoints (e): willow.main (bf16, --runs 2): run 2\'s first '
        f'replayed step bit-identical to an eager step from the snapshot '
        f'(outputs and {len(seen["after"])} parameters); accuracies '
        f'{accs.round(2).tolist()}')


def _kp_pascal_pf(pf):
    """(f) ``pascal_pf.main --data_root`` on the PascalPF fixture: every
    category's pairs evaluated one at a time, one captured eval graph for
    each padded size."""
    from dgmc_tpu_torch.datasets.pascal_pf import CATEGORIES, PascalPF
    from dgmc_tpu_torch.experiments import pascal_pf
    made = []
    make = pascal_pf.make_eval_step

    def recording(*a, **kw):
        made.append(make(*a, **kw))
        return made[-1]

    pascal_pf.make_eval_step = recording
    try:
        _kp_run('keypoints (f) pascal_pf --data_root', pascal_pf.main,
                ['--data_root', pf, '--epochs', '1'], 'bf16', None)
    finally:
        pascal_pf.make_eval_step = make
    sizes = {max(g.pos.shape[0] for g in PascalPF(pf, c).items.values())
             for c in CATEGORIES}
    records = made[0].jit.compiled.records
    if len(records) != len(sizes):
        raise AssertionError(f'keypoints (f): {len(records)} eval graphs '
                             f'for {len(sizes)} category sizes')
    log(f'keypoints (f): {len(records)} captured eval graphs, one per '
        f'category size {sorted(sizes)}')


#: The run plane's artifacts and the top-level keys each has in the JAX
#: package (``tests/test_torch_obs_run.py`` holds the port's equal to
#: JAX's on the CPU; this machine has no JAX); a ``.jsonl`` maps to the
#: keys every record has.
OBS_KEYS = {
    'metrics.jsonl': {'step', 'time'},
    'timings.json': {'wall_s', 'argv', 'steps', 'compile',
                     'padding_buckets', 'flight', 'events_truncated'},
    'memory.json': {'snapshots'},
    'dispatch.json': {'counts'},
    'quality.json': {'schema', 'headline', 'scenarios', 'consensus',
                     'serve'},
    'trace.json': {'traceEvents', 'displayTimeUnit', 'otherData'},
    'anomalies.json': {'version', 'capacity', 'truncated', 'signals',
                       'events'},
    'slo.json': {'version', 'slo', 'time', 'spec', 'objectives', 'floors',
                 'breaches'},
    'heartbeat.json': {'time', 'pid', 'last_event', 'in_flight', 'port',
                       'host'},
    'hang_report.json': {'reason', 'time', 'pid', 'argv', 'deadline_s',
                         'stalled_for_s', 'in_flight', 'last_completed',
                         'context', 'threads'},
    'flight.json': {'reason', 'time', 'pid', 'argv', 'capacity',
                    'events_seen', 'events_recorded', 'events_truncated',
                    'events'},
}
#: The obs phase's KG run: 10 phase-1 epochs, then 3 of phase 2, the
#: second of which has its gradients poisoned.
OBS_KG_ARGV = ['--epochs', '13', '--phase1_epochs', '10',
               '--guard-bad-steps', '1', '--inject-fault', 'nan-grads@12']
OBS_STEPS = 30


def _hold_artifact(label, directory, name):
    """``name`` exists in ``directory`` with (at least) JAX's top-level
    keys (:data:`OBS_KEYS`); returns the parsed payload (a list of
    records for a ``.jsonl``)."""
    path = os.path.join(directory, name)
    if not os.path.isfile(path):
        raise AssertionError(f'{label}: {name} was not written')
    with open(path) as f:
        if name.endswith('.jsonl'):
            payload = [json.loads(line) for line in f]
            missing = [OBS_KEYS[name] - set(r) for r in payload]
            missing = set().union(*missing) if missing else OBS_KEYS[name]
        else:
            payload = json.load(f)
            missing = OBS_KEYS[name] - set(payload)
    if missing:
        raise AssertionError(f'{label}: {name} lacks {sorted(missing)}')
    return payload


def _scrape(port, path):
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(f'http://127.0.0.1:{port}{path}',
                                    timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _obs_kg(tmp):
    """(a) DBP15K at full width (bf16, the CLI's default, blocked
    adjacency), observed, with the guard and a poisoned phase-2 step;
    (d)'s guard half."""
    from dgmc_tpu_torch.ops.kernels import dispatch
    from dgmc_tpu_torch.utils.io import write_json_atomic
    d = os.path.join(tmp, 'kg')
    spec = os.path.join(tmp, 'slo.json')
    write_json_atomic(spec, {'name': 'kg',
                             'availability': {'objective': 0.99},
                             'latency': [{'name': 'step',
                                          'threshold_ms': 1000.0,
                                          'objective': 0.9}]})
    marks, scrapes, mfus = [], [], []
    prof = os.path.join(tmp, 'kg_prof')

    def hook(kind, epoch, out):
        marks.append((kind, epoch, dispatch.launch_counts()))
        if kind != 'train':
            return
        with open(os.path.join(d, 'heartbeat.json')) as f:
            port = json.load(f)['port']
        code, _ = _scrape(port, '/healthz')
        m_code, metrics = _scrape(port, '/metrics')
        # dgmc_mfu against the efficiency.json of the same flush (the
        # observer flushes at epoch ends, after this hook).
        with open(os.path.join(d, 'efficiency.json')) as f:
            mfus.append((_mfu_sample(metrics), json.load(f).get('mfu')))
        s_code, status = _scrape(port, '/status')
        count = re.search(r'^dgmc_step_latency_seconds_count (\d+)$',
                          metrics, re.M)
        scrapes.append((epoch, code, m_code, s_code,
                        int(count.group(1)) if count else None,
                        json.loads(status)['steps'].get('steps')))

    # Every flight.json dump's reason (a later anomaly dump, say of the
    # phase-2 steps' longer latency, may replace the rollback's file).
    from dgmc_tpu_torch.obs import live
    reasons, dump = [], live.FlightRecorder.dump

    def recorded_dump(self, reason, **kw):
        reasons.append(reason)
        return dump(self, reason, **kw)
    live.FlightRecorder.dump = recorded_dump
    dispatch.reset()
    t0 = time.perf_counter()
    try:
        _kg_cli(KG_ARGV + OBS_KG_ARGV + [
            '--obs-dir', d, '--obs-port', '0', '--probes',
            '--watchdog-deadline', '120', '--slo', spec,
            '--metrics_log', os.path.join(tmp, 'kg.jsonl'),
            '--profile-dir', prof, '--profile-steps', '11:13'], hook)
    finally:
        live.FlightRecorder.dump = dump
    seconds = time.perf_counter() - t0
    counts = _kg_marks('obs (a)', marks, 10)
    bad = [s for s in scrapes
           if s[1:4] != (200, 200, 200) or s[4] != s[0] or s[5] != s[0]]
    if len(scrapes) != 13 or bad:
        raise AssertionError(f'obs (a): scrapes (epoch, /healthz, /metrics, '
                             f'/status, histogram count, status steps) '
                             f'{bad or scrapes}')
    got = {n: _hold_artifact('obs (a)', d, n) for n in OBS_KEYS
           if n != 'hang_report.json'}
    timings = got['timings.json']
    per_step = collections.defaultdict(collections.Counter)
    for r in got['metrics.jsonl']:
        if 'probe' in r:
            per_step[r['step']][r['probe']] += 1
    L = 10
    want = {'corr_entropy': 2 + L, 'topk_mass': 2, 'consensus_delta': L,
            'grad_norm': 1}
    for step in (10, 11, 12):
        have = {k: per_step[step][k] for k in want}
        if have != want:
            raise AssertionError(f'obs (a): phase-2 step {step} probes '
                                 f'{have}, expected {want}')
    nonfinite = timings['probes']['nonfinite']['count']
    if nonfinite != 10 * 4 + 3 * (4 + L):
        raise AssertionError(f'obs (a): {nonfinite} nonfinite checks, '
                             f'expected {10 * 4 + 3 * (4 + L)}')
    first = timings.get('first_nonfinite')
    if first != {'step': 11, 'stage': 'grad', 'order': 1001}:
        raise AssertionError(f'obs (d): first offender {first}, expected '
                             f'grad at step 11 (optimizer step 12)')
    flight = got['flight.json']
    if 'guard-rollback' not in reasons:
        raise AssertionError(f'obs (d): flight.json dumps {reasons}, none '
                             f'at the rollback')
    comp = timings['compile']
    by_label = {k: v['events'] for k, v in comp['by_label'].items()}
    if by_label != {'phase1': 1, 'phase2': 1, 'run': 2}:
        raise AssertionError(f'obs (a): compile events by label {by_label}, '
                             f'expected one capture per step function')
    with open(os.path.join(d, 'timings.json')) as f:
        LINT_OBS['obs (a) KG'] = f.read()
    log(f'obs (a): dbp15k.main, 13 epochs (10 of phase 1), bf16, '
        f'observed, in {seconds:.1f}s: launches '
        f'{dict((k, counts[k]) for k in KG_KERNELS)} at KG_PER\'s counts; '
        f'13 scrapes: /healthz, /metrics, /status 200, the step '
        f'histogram counting each step; artifacts '
        f'{sorted(os.listdir(d))} with JAX\'s top-level keys; probes per '
        f'phase-2 step {want} and {4 + L} nonfinite checks; captures '
        f'{by_label} ({comp["compile_s"]:.2f}s), none in steady state; '
        f'step p50 {timings["steps"]["p50_s"] * 1e3:.3f} ms (host: the '
        f'replay call)')
    log(f'obs (d): nan-grads@12 under --guard-bad-steps 1: first offender '
        f'{first}, flight.json dumps {reasons} ({flight["events_recorded"]} '
        f'events in the last)')
    t0 = time.perf_counter()
    if all(a is None for a, _ in mfus) or any(a != b for a, b in mfus):
        raise AssertionError(f'obs (a): /metrics dgmc_mfu against '
                             f'efficiency.json: {mfus}')
    eff = _hold_efficiency('obs (a)', d, {
        'phase1_step': ('psi1', 'initial_corr', 'topk', 'loss',
                        'optimizer'),
        'train_step': ('psi1', 'initial_corr', 'topk', 'consensus_iter',
                       'psi2', 'loss', 'optimizer')})
    _hold_kg_counts(eff['programs']['train_step'])
    _hold_attribution('obs (a) KG phase 2', prof, d,
                      ('psi1', 'topk', 'consensus_iter', 'psi2', 'loss',
                       'optimizer'))
    summary = json.loads(_module_main('dgmc_tpu_torch.obs.report', d,
                                      '--json'))
    if summary.get('mfu') != eff['mfu']:
        raise AssertionError(f'obs (a): the report\'s mfu '
                             f'{summary.get("mfu")} against '
                             f'efficiency.json\'s {eff["mfu"]}')
    log(f'obs (a): python -m dgmc_tpu_torch.obs.report --json (its main, '
        f'in this process): mfu '
        f'{summary["mfu"]} as efficiency.json, measured_mfu '
        f'{summary.get("measured_mfu")}, goodput '
        f'{summary.get("goodput_ratio")}; the cost checks took '
        f'{time.perf_counter() - t0:.1f}s')


def _mfu_sample(text):
    m = re.search(r'^dgmc_mfu (\S+)$', text, re.M)
    return float(m.group(1)) if m else None


def _module_main(module, *args):
    """The command line ``python -m module args`` run in this process,
    through the module's ``main`` (no interpreter start-up) → its
    standard output (raises on a non-zero exit)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = importlib.import_module(module).main(list(args))
    if rc:
        raise AssertionError(f'python -m {module} exited {rc}')
    return out.getvalue()


def _hold_efficiency(label, d, need):
    """``efficiency.json`` of the run in ``d`` has each program of
    ``need`` with a stage table naming its stages, the headline MFU is
    flops / (step p50 x peak) to 4 significant digits (within 2e-3, the
    payload keeping p50 to the microsecond) and lies in (0, 1], and
    ``goodput.json``'s ratio lies in (0, 1] → the efficiency payload."""
    with open(os.path.join(d, 'efficiency.json')) as f:
        eff = json.load(f)
    with open(os.path.join(d, 'goodput.json')) as f:
        good = json.load(f)
    for name, stages in need.items():
        have = set((eff['programs'].get(name) or {}).get('stages') or ())
        if not set(stages) <= have:
            raise AssertionError(f'{label}: efficiency.json {name} stages '
                                 f'{sorted(have)}, expected {stages}')
    ts = eff['programs']['train_step']
    want = ts['flops'] / (ts['step_time_s'] * eff['peak_flops'])
    if not (0 < eff['mfu'] <= 1 and abs(eff['mfu'] - want) <= 2e-3 * want):
        raise AssertionError(f'{label}: mfu {eff["mfu"]}, flops / (p50 x '
                             f'peak) {want}')
    if not 0 < good['goodput_ratio'] <= 1:
        raise AssertionError(f'{label}: goodput.json {good}')
    for name, p in eff['programs'].items():
        log(f'{label}: efficiency.json {name}: {p["flops"] / 1e12:.4f} '
            f'TFLOP, {p["bytes"] / 1e9:.3f} GB, intensity '
            f'{p.get("arith_intensity")}, step p50 '
            f'{p["step_time_s"] * 1e3:.3f} ms (the replay call on the '
            f'host), mfu {p.get("mfu")} against {eff["peak_flops_ref"]}; '
            f'stage TFLOP ' + ', '.join(
                f'{s} {r["flops"] / 1e12:.4f}'
                for s, r in p['stages'].items()))
    log(f'{label}: goodput.json ratio {good["goodput_ratio"]} '
        f'(FLOP-weighted: {good["composed_with_stage_flops"]})')
    return eff


def _hold_kg_counts(counted):
    """The KG phase-2 step's counted kernels (``efficiency.json``'s
    ``train_step``) against each kernel's formula at the step's shapes x
    its launches a step (:data:`KG_PER`); then the same step's count
    with the kernels and with their plain versions on the card
    (:func:`plain_on_card`) from one state and seed: the same account,
    and the CLI's."""
    from dgmc_tpu_torch.experiments import dbp15k
    from dgmc_tpu_torch.obs.cost import cost_summary
    from dgmc_tpu_torch.ops.graph import GraphBatch
    from dgmc_tpu_torch.ops.kernels.blocked import blocked_work
    from dgmc_tpu_torch.ops.kernels.sparse_consensus import sc_work
    from dgmc_tpu_torch.ops.kernels.topk import topk_work
    args = dbp15k.parse_args(KG_ARGV)
    train_b, _, _ = dbp15k.synthetic_batches(args)
    g_s, g_t = GraphBatch.host(train_b.s), GraphBatch.host(train_b.t)
    N_s, N_t = g_s.num_nodes, g_t.num_nodes
    K, R, L = args.k + min(args.k, N_t - args.k), args.rnd_dim, args.num_steps
    n_topk, n_fwd, n_bwd, n_blocked, _ = KG_PER[('train', 2)]
    E_s, E_t = (blocked_work(g.blocks_in, 1, 4)['flops'] for g in (g_s, g_t))
    # ψ₁ (detached) forward on both graphs, 3 layers of 2 aggregations;
    # ψ₂ packed on the source (T x R channels) and per step on the
    # target, each forward and backward.
    blocked = (6 * (E_s + E_t) * args.dim + 12 * E_s * L * R
               + 12 * L * E_t * R)
    want = {'topk': (n_topk, topk_work(1, N_s, N_t, args.dim,
                                       args.k)['flops']),
            'sparse_consensus_bwd': (n_bwd, n_bwd * sc_work(
                1, N_s, N_t, K, R)['bwd']['flops']),
            'blocked': (n_blocked, blocked)}
    got = {k: (v['calls'], v['flops']) for k, v in counted['kernels'].items()}
    bad = {k: (got.get(k), w) for k, w in want.items() if got.get(k) != w}
    fwd = got.get('sparse_consensus_fwd', (0, 0))
    # The forward reads the touched target rows T only: T from its count.
    per = fwd[1] / max(fwd[0], 1) - 3.0 * N_s * K * R
    T = per / (2.0 * R * R) - N_s
    if bad or fwd[0] != n_fwd or T != int(T) or not 0 < T <= N_t:
        raise AssertionError(f'obs (a): counted kernels {bad or got}, the '
                             f'forward\'s touched rows {T}')
    log(f'obs (a): counted kernels of the phase-2 step at their formulas x '
        f'launches: {dict(sorted(got.items()))} (the forward over {int(T)} '
        f'touched target rows of {N_t})')
    run = kg_step('bf16', jit=False)
    seed = dbp15k.noise_seed(0, 0, 11)
    eager = cost_summary(run.step, run.state, run.batch, seed)
    with plain_on_card():
        plain = cost_summary(run.step, run.state, run.batch, seed)
    # The CLI counted with its probes on (their ops, no FLOPs or kernels).
    def flops(summary):
        return ({s: r['flops'] for s, r in summary['stages'].items()},
                summary['kernels'])
    if plain != eager or flops(eager) != flops(counted):
        diff = {k: (eager[k], plain[k]) for k in eager
                if eager[k] != plain.get(k)}
        raise AssertionError(f'obs (a): the count with kernels against '
                             f'plain versions: {diff}; stage FLOPs and '
                             f'kernels {flops(eager)} against the CLI\'s '
                             f'{flops(counted)}')
    log(f'obs (a): the eager phase-2 step counts {eager["flops"]:.6g} FLOP '
        f'with the kernels and with their plain versions on the card, as '
        f'the CLI\'s account')
    del run
    gc.collect()
    torch.cuda.empty_cache()


def _hold_dense_counts(label, kernels, model, batch, D):
    """A dense train step's counted kernels (``kernels``: a cost
    summary's ``{name: {'calls', 'flops'}}``) against each kernel's
    formula at the batch's shapes x its launches a step: SplineConv's
    routing, forward and ``d_t``, ``2 A O`` a real edge (``A = 2^D``
    knots) a call, ψ₁'s ``num_layers`` calls on each graph at its width
    and ψ₂'s ``num_layers`` on each graph in each of ``num_steps`` steps
    (one channel-packed source call a layer where the model packs); the
    dense consensus ``num_steps`` times
    (:func:`~dgmc_tpu_torch.ops.kernels.consensus.consensus_work`,
    forward and backward)."""
    from dgmc_tpu_torch.ops.kernels.consensus import consensus_work
    y = np.asarray(batch.y)
    B, N_s = y.shape
    N_t = np.shape(batch.t['x'])[1]
    L, T = len(model.psi_1.convs), model.num_steps
    L2 = len(model.psi_2.convs)
    O1, R = model.psi_1.channels, model.psi_2.channels
    E = float(np.asarray(batch.s['edge_mask']).sum()
              + np.asarray(batch.t['edge_mask']).sum())
    route = 2.0 * 2 ** D * E * (L * O1 + T * L2 * R)
    calls = 2 * L + (L2 + T * L2 if model.packs_source(T) else 2 * T * L2)
    work = consensus_work(B, N_s, N_t, R)
    want = {'spline_route_fwd': (calls, route),
            'spline_route_bwd': (calls, route),
            'consensus_fwd': (T, T * work['flops']),
            'consensus_bwd': (T, T * work['bwd']['flops'])}
    got = {k: (kernels.get(k, {}).get('calls'), kernels.get(k, {}).get(
        'flops')) for k in want}
    if got != want:
        raise AssertionError(f'{label}: counted kernels {got}, the '
                             f'formulas x launches {want}')
    log(f'{label}: counted kernels at their formulas x launches (D = {D}, '
        f'{int(E)} real edges, B = {B}, N_s = {N_s}, N_t = {N_t}): '
        f'{dict(sorted(got.items()))}')


def _hold_attribution(label, prof, obs_dir, need):
    """``python -m dgmc_tpu_torch.obs.attribution`` (its ``main``, in this
    process) on the profiled steps in ``prof``: the stage sums no more
    than the card's busy time, each stage of ``need`` nonzero, every
    replay matched to its warm-up (the unmatched share 0), the measured
    MFU in (0, 1] → the payload."""
    payload = json.loads(_module_main('dgmc_tpu_torch.obs.attribution',
                                      prof, '--obs-dir', obs_dir, '--json'))
    occ, stages = payload['occupancy'], payload['stages']
    busy, steps = occ['device_active_s'], payload['steps']['observed']
    total = sum(r['wall_s'] for r in stages.values())
    mfu = (payload['reconciliation'] or {}).get('measured_mfu')
    missing = [s for s in need if not (stages.get(s) or {}).get('wall_s')]
    log(f'{label}: attribution over {steps} profiled steps: busy '
        f'{busy * 1e3 / steps:.3f} ms a step, idle '
        f'{occ["device_idle_fraction"]} of the window, host waits '
        f'{occ["host_wait_s"]} s; replays {payload["replays"]}, unmatched '
        f'share {payload["unmatched_share"]}; measured mfu {mfu}; sources '
        f'{payload["stage_sources"]}; ms a step by stage: ' + ', '.join(
            f'{s} {r["wall_s"] * 1e3 / steps:.3f}'
            for s, r in stages.items()))
    if total > busy + 1e-6 * len(stages) or missing \
            or payload['unmatched_share'] != 0 \
            or not payload['replays']['count'] \
            or not (mfu and 0 < mfu <= 1):
        raise AssertionError(f'{label}: stage sum {total} s against busy '
                             f'{busy} s, stages without time {missing}, '
                             f'unmatched share {payload["unmatched_share"]}'
                             f', measured mfu {mfu}')
    return payload


def _obs_variants(label, make, calls, policy):
    """(b) for one captured step: ``make(jit)`` builds a fresh model (the
    same seed) and returns ``run()``. A: no observer; B: an observer with
    probes off; C: an observer with probes on; E: the eager step with
    probes on. A and B: outputs bit-identical, the same launches a
    replay (the record's and the counters'). C and E: the probe tapes
    bit-identical. Returns the three captured calls and observers for
    (e)."""
    import tempfile
    from dgmc_tpu_torch.obs import probes
    from dgmc_tpu_torch.obs.run import RunObserver
    from dgmc_tpu_torch.ops.kernels import dispatch

    def drive(run, obs, n):
        outs = []
        dispatch.reset()
        for _ in range(n):
            with obs.step():
                outs.append(_clone(run()[1]))
        torch.cuda.synchronize()
        return outs, dispatch.launch_counts()

    def record(run):
        (rec,) = run.step.jit.compiled.records.values()
        return rec

    tmp = tempfile.mkdtemp(prefix='dgmc_obs_')
    no_obs = RunObserver(None)
    run_a = make(True)
    out_a, cnt_a = drive(run_a, no_obs, calls)
    obs_b = RunObserver(os.path.join(tmp, 'b'))
    run_b = make(True)
    out_b, cnt_b = drive(run_b, obs_b, calls)
    for i, (a, b) in enumerate(zip(out_a, out_b)):
        _hold_identical(f'obs (b) {label} {policy} call {i}', a, b,
                        'no observer and probes off')
    if record(run_a).launches != record(run_b).launches or cnt_a != cnt_b:
        raise AssertionError(f'obs (b) {label} {policy}: launches '
                             f'{record(run_b).launches} / {cnt_b} against '
                             f'{record(run_a).launches} / {cnt_a}')
    obs_c = RunObserver(os.path.join(tmp, 'c'), probes=True)
    tape = probes.ProbeLog()
    probes.add_sink(tape)
    try:
        run_c = make(True)
        drive(run_c, no_obs, calls)
        probes.drain(wait=True)
        captured, tape.records = tape.records, []
        drive(make(False), no_obs, calls)
        probes.drain(wait=True)
        eager = tape.records
    finally:
        probes.remove_sink(tape)

    def values(records):
        return [(r['probe'], r.get('stage'), r.get('iteration'), r['value'])
                for r in records]
    if not captured or values(captured) != values(eager):
        raise AssertionError(f'obs (b) {label} {policy}: the captured '
                             f'tape differs from the eager one')
    log(f'obs (b): {label} {policy}: {calls} replays with an observer and '
        f'probes off bit-identical to no observer, launches a replay '
        f'{record(run_a).launches}; with probes on {len(captured)} probe '
        f'values, the captured tape bit-identical to the eager one, '
        f'launches a replay {record(run_c).launches}')
    return (run_a, run_b, run_c), (no_obs, obs_b, obs_c)


def _obs_cost(runs, observers, smi_line):
    """(e): the medians of ``OBS_STEPS`` synchronized steps each, three
    ways (no observer, an observer with probes off, one with probes on),
    in turns A B C C B A, each step's probe records delivered inside its
    window; then, the same ways in turns, ``OBS_STEPS`` steps back to
    back with one synchronization and the last drain at the end (the
    CLI's loop, whose host work overlaps the card's) and one profiled
    replay each: its device ops and device busy time."""
    from dgmc_tpu_torch.obs import probes
    keys = ('none', 'probes off', 'probes on')
    order = list(zip(keys, runs, observers))

    def observed(run, obs):
        with obs.step():
            run()

    def step_and_records(run, obs):
        # A step's records delivered inside its own window: the drain is
        # process-wide, so a later step of another way would pay for them.
        observed(run, obs)
        torch.cuda.synchronize()
        probes.drain(wait=True)

    times = {k: [] for k in keys}
    for _ in range(OBS_STEPS // 2):
        for key, run, obs in order + order[::-1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step_and_records(run, obs)
            times[key].append((time.perf_counter() - t0) * 1e3)
    loops = {k: [] for k in keys}
    for key, run, obs in order + order[::-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(OBS_STEPS):
            observed(run, obs)
        torch.cuda.synchronize()
        probes.drain(wait=True)
        loops[key].append((time.perf_counter() - t0) * 1e3 / OBS_STEPS)
    parts = []
    for key, run, obs in order:
        ts = sorted(times[key])
        q1, q3 = ts[len(ts) // 4], ts[(3 * len(ts)) // 4]
        rows, _ = _profiled(functools.partial(observed, run, obs))
        busy = sum(r[0] for r in rows) / 1e3
        parts.append(f'{key}: median {statistics.median(ts):.3f} ms (min '
                     f'{ts[0]:.3f}, max {ts[-1]:.3f}, quartiles {q1:.3f}-'
                     f'{q3:.3f}), back to back {loops[key][0]:.3f} / '
                     f'{loops[key][1]:.3f} ms a step, one replay '
                     f'{sum(r[2] for r in rows)} device ops, busy '
                     f'{busy:.3f} ms')
    log(f'obs (e): KG phase-2 step, bf16, captured, {OBS_STEPS} '
        f'synchronized steps each, in turns: {"; ".join(parts)} on '
        f'{smi_line}')


def _obs_stall(tmp):
    """(d)'s watchdog half: a device-side stall (``torch.cuda._sleep``
    keeps the stream busy past the deadline) while the main thread
    synchronizes: ``/healthz`` turns 503, ``hang_report.json`` shows the
    main thread in the synchronize, ``flight.json`` is dumped; the plane
    answers 200 again after it."""
    import threading
    from dgmc_tpu_torch.obs.run import RunObserver
    d = os.path.join(tmp, 'stall')
    deadline = 0.5
    obs = RunObserver(d, watchdog_deadline_s=deadline, obs_port=0)
    codes, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            codes.append(_scrape(obs.live_port, '/healthz')[0])
            time.sleep(0.1)

    cycles = 8 * 10 ** 9      # ~4 s at the H100's ~2 GHz
    poller = threading.Thread(target=poll, daemon=True)
    try:
        with obs.step():
            poller.start()
            t0 = time.perf_counter()
            torch.cuda._sleep(cycles)
            torch.cuda.synchronize()
            stalled = time.perf_counter() - t0
        stop.set()
        poller.join(10)
        after = _scrape(obs.live_port, '/healthz')[0]
    finally:
        stop.set()
        obs.close()
    report = _hold_artifact('obs (d)', d, 'hang_report.json')
    flight = _hold_artifact('obs (d)', d, 'flight.json')
    (main,) = [t for t in report['threads'] if t['name'] == 'MainThread']
    in_sync = any('synchronize' in line for line in main['stack'][-3:])
    if stalled < 2.5 * deadline or 503 not in codes or 200 not in codes \
            or after != 200 or not in_sync or report['reason'] != 'deadline':
        raise AssertionError(f'obs (d): a {stalled:.2f}s device stall: '
                             f'/healthz {codes} then {after}, report '
                             f'{report["reason"]}, main thread '
                             f'{main["stack"][-2:]}')
    log(f'obs (d): a {stalled:.2f}s device stall (torch.cuda._sleep) under '
        f'a {deadline}s deadline: /healthz {codes.count(200)} x 200 then '
        f'{codes.count(503)} x 503, 200 after; hang_report.json with the '
        f'main thread in torch.cuda.synchronize; flight.json '
        f'({flight["reason"]})')


def _obs_profile(tmp):
    """(c): ``pascal_pf.main`` at the CLI's width with ``--profile-dir
    --profile-steps 1:3``: one trace, with the two steps' ranges and the
    port's kernels by name."""
    from dgmc_tpu_torch.experiments import pascal_pf
    d = os.path.join(tmp, 'prof')
    obs_dir = os.path.join(tmp, 'pf_obs')
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        pascal_pf.main(['--epochs', '1', '--seed', '0', '--profile-dir', d,
                        '--profile-steps', '1:3', '--obs-dir', obs_dir])
    # The run's trace, and the warm-up trace of each capture outside the
    # window.
    warmups = [f for f in os.listdir(d) if f.startswith('dgmc_warmup.')]
    files = [f for f in os.listdir(d) if f.startswith('dgmc_torch.')]
    if len(files) != 1 or not warmups:
        raise AssertionError(f'obs (c): trace files {os.listdir(d)}')
    with open(os.path.join(d, files[0])) as f:
        events = json.load(f)['traceEvents']
    names = collections.Counter(e.get('name', '') for e in events)
    kernels = collections.Counter()
    for e in events:
        m = PORT_KERNEL.search('::' + e.get('name', '').split('::')[-1])
        if m and e.get('cat') == 'kernel':
            kernels[m.group(1)] += 1
    steps = sorted(n for n in names if n.startswith('dgmc_step#'))
    need = {'route_fwd', 'route_dt', 'consensus_pairs', 'project_rows'}
    have = {k.split('<')[0] for k in kernels}
    if steps != ['dgmc_step#1', 'dgmc_step#2'] or not need <= have:
        raise AssertionError(f'obs (c): steps {steps}, port kernels '
                             f'{dict(kernels)}')
    log(f'obs (c): pascal_pf.main --profile-dir --profile-steps 1:3 in '
        f'{time.perf_counter() - t0:.1f}s: {files[0]} with {len(events)} '
        f'events, ranges {steps}, the port\'s kernels by name '
        f'{dict(sorted(kernels.items()))}; {len(warmups)} warm-up traces')
    eff = _hold_efficiency('obs (c) PascalPF', obs_dir, {'train_step': (
        'psi1', 'initial_corr', 'consensus_iter', 'psi2', 'loss',
        'optimizer')})
    args = pascal_pf.parse_args(['--epochs', '1', '--seed', '0'])
    model, loader, _ = pascal_pf.build(args)
    _hold_dense_counts('obs (c) PascalPF',
                       eff['programs']['train_step']['kernels'], model,
                       loader.first_batch(), 2)
    _hold_attribution('obs (c) PascalPF', d, obs_dir,
                      ('psi1', 'initial_corr', 'consensus_iter', 'psi2',
                       'loss', 'optimizer'))


#: The JAX CI's tiny observed PascalPF run (``.github/workflows/ci.yml``),
#: steps 1-4 profiled as the CI's candidate is.
PF_TINY = ['--epochs', '1', '--batch_size', '8', '--dim', '16',
           '--rnd_dim', '8', '--num_steps', '1', '--seed', '0',
           '--profile-steps', '1:5']
#: The calibrated diff's significance. With three repeats the MAD is the
#: smaller of two deviations from the median, so (x2 - x1) / (1.4826 MAD)
#: of two of the repeats has heavy tails: under normal noise it passes 3
#: in 10% of draws and 100 in 0.4% (by simulation), and the default z = 3
#: fails one of five such gates in about two diffs of five.
CALIBRATION_Z = '100'
#: Seconds of each run-comparison reader on the card's artifacts.
READER_S = collections.defaultdict(float)


def _reader(name, *argv):
    """``dgmc_tpu_torch.obs.<name>.main(argv)`` in this process, its
    output captured and its seconds added to :data:`READER_S` →
    ``(rc, stdout)``."""
    mod = importlib.import_module(f'dgmc_tpu_torch.obs.{name}')
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(list(argv))
    READER_S[name] += time.perf_counter() - t0
    return rc, buf.getvalue()


def _diff_rows(label, want_rc, *argv):
    """``diff --json`` of ``argv`` → its rows by metric; raises unless it
    exits ``want_rc`` (``None``: any exit code)."""
    rc, out = _reader('diff', *argv, '--json')
    rows = {r['metric']: r for r in json.loads(out)['rows']}
    if want_rc is not None and rc != want_rc:
        bad = {m: (r['a'], r['b'], r['status'], r['note'])
               for m, r in rows.items() if r['status'] == 'REGRESSION'}
        raise AssertionError(f'{label}: diff exited {rc}, expected '
                             f'{want_rc}; regressions {bad}')
    return rows


def _launched(d, counts=False):
    """The kernels whose CUDA kernel launched in the run in ``d`` (with
    ``counts``, ``{kernel: launches}``)."""
    with open(os.path.join(d, 'dispatch.json')) as f:
        rows = [r for r in json.load(f)['counts']
                if r['outcome'] == 'kernel' and r['count']]
    if counts:
        total = collections.Counter()
        for r in rows:
            total[r['kernel']] += r['count']
        return dict(sorted(total.items()))
    return sorted({r['kernel'] for r in rows})


def _tiny_pf_argv(tmp, name):
    """The obs dir, the profile dir and the flags of :func:`_tiny_pf`'s
    run ``name`` in ``tmp``."""
    d, prof = os.path.join(tmp, name), os.path.join(tmp, f'{name}_prof')
    return d, prof, PF_TINY + ['--obs-dir', d, '--profile-dir', prof,
                               '--data_root', os.path.join(tmp, 'none')]


def _start_cpu_pf(tmp, name):
    """:func:`_tiny_pf`'s run ``name`` as ``python -m ... --device cpu``
    with no card visible, started in the background with one intra-op
    thread (it runs beside the phase's work on the card) → the process,
    its output in ``tmp/name.log``."""
    _, _, argv = _tiny_pf_argv(tmp, name)
    out = open(os.path.join(tmp, f'{name}.log'), 'w+')
    proc = subprocess.Popen(
        [sys.executable, '-m', 'dgmc_tpu_torch.experiments.pascal_pf',
         '--device', 'cpu', *argv], cwd=ROOT, stdout=out,
        stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES='', OMP_NUM_THREADS='1'))
    proc.out = out
    return proc


def _tiny_pf(tmp, name, cpu=None):
    """The tiny observed, profiled ``pascal_pf`` run in ``tmp/name``, its
    attribution merged into its ``efficiency.json``: on the card in this
    process (the allocator's peak reset first), or the run on the CPU
    that ``cpu`` (:func:`_start_cpu_pf`) is, once it has exited → the obs
    dir."""
    d, prof, argv = _tiny_pf_argv(tmp, name)
    if cpu is not None:
        rc = cpu.wait(timeout=600)
        cpu.out.seek(0)
        text = cpu.out.read()
        cpu.out.close()
        if rc:
            raise AssertionError(f'obs (f): the CPU run exited {rc}: '
                                 f'{text[-2000:]}')
    else:
        from dgmc_tpu_torch.experiments import pascal_pf
        # The last run's graphs sit in reference cycles: the peak is this
        # run's alone once they are collected.
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with contextlib.redirect_stdout(io.StringIO()):
            pascal_pf.main(argv)
    from dgmc_tpu_torch.obs import attribution
    with contextlib.redirect_stdout(io.StringIO()):
        rc = attribution.main([prof, '--obs-dir', d])
    if rc:
        raise AssertionError(f'obs (f): attribution of {name} exited {rc}')
    return d


def _obs_readers(tmp, cpu_run):
    """(f) the run-comparison readers over this phase's artifacts:
    ``aggregate`` and ``diff A A`` over (a)'s KG dir, ``calibrate`` over
    three tiny PascalPF runs on the card and the calibrated diff of two
    of them, and the same run on the CPU (``cpu_run``, started with the
    phase) against the card's."""
    from dgmc_tpu_torch.obs.report import load_run, summarize
    t0 = time.perf_counter()
    kg = os.path.join(tmp, 'kg')
    rc, _ = _reader('aggregate', kg)
    with open(os.path.join(kg, 'aggregate.json')) as f:
        agg = json.load(f)
    skew = summarize(load_run(kg)).get('skew') or {}
    if rc or agg['hosts'] != 1 or len(agg['devices']) != 1 \
            or agg['skew']['step_time_ratio'] != 1.0 \
            or skew.get('step_time_ratio') != 1.0:
        raise AssertionError(f'obs (f): aggregate exited {rc}: hosts '
                             f'{agg["hosts"]}, devices {agg["devices"]}, '
                             f'skew {agg["skew"]}, the report\'s {skew}')
    # (a) poisons a step (nan-grads@12): a candidate that went
    # non-finite fails the diff whatever its baseline (JAX's rule), so
    # the run against itself exits 1 with that row its one regression.
    rows = _diff_rows('obs (f) KG against itself', 1, kg, kg)
    failed = [m for m, r in rows.items() if r['status'] == 'REGRESSION']
    if failed != ['first_nonfinite'] \
            or "step 11 stage 'grad'" not in rows[failed[0]]['note']:
        raise AssertionError(f'obs (f): KG against itself: regressions '
                             f'{failed}')
    launched = _launched(kg)
    need = ['mfu', 'idle_fraction', 'peak_memory_bytes', 'compile_events',
            'skew_step_time_ratio'] + [f'dispatch[{k}]' for k in launched]
    bad = {m: rows.get(m) for m in need
           if (rows.get(m) or {}).get('status') != 'ok'}
    notes = (rows['idle_fraction']['note'],
             rows['peak_memory_bytes']['note'])
    if bad or not launched or not all(n.endswith('source=device')
                                      for n in notes):
        raise AssertionError(f'obs (f): KG diff rows {bad or notes}')
    log(f'obs (f): aggregate over (a): 1 host, device '
        f'{agg["devices"][0]["device"]} ({agg["devices"][0]["steps"]} '
        f'fences), step-time ratio {agg["skew"]["step_time_ratio"]}, '
        f'the report carries it; diff (a) (a): rc 1, the one regression '
        f'first_nonfinite ({rows["first_nonfinite"]["note"]}), ok rows '
        f'{sorted(need)}')

    runs = [_tiny_pf(tmp, f'pf{i}') for i in (1, 2, 3)]
    cal = os.path.join(tmp, 'calibration.json')
    rc, _ = _reader('calibrate', *itertools.chain.from_iterable(
        ('--obs-dir', d) for d in runs), '--out', cal)
    with open(cal) as f:
        fit = json.load(f)['metrics']
    if rc or fit['step_p50_s']['n'] != 3:
        raise AssertionError(f'obs (f): calibrate exited {rc}')
    for key in ('step_p50_s', 'mfu', 'peak_memory_bytes', 'idle_fraction'):
        log(f'obs (f): calibrate over three tiny PascalPF runs: {key} '
            f'median {fit[key]["median"]}, rel_sigma {fit[key]["rel_sigma"]}'
            f' (min {fit[key]["min"]}, max {fit[key]["max"]})')
    rows = _diff_rows('obs (f) run 1 against run 2, calibrated', 0,
                      runs[0], runs[1], '--calibration', cal,
                      '--calibration-z', CALIBRATION_Z)
    calibrated = sorted(m for m in rows if m.startswith('calibrated:'))
    if not calibrated:
        raise AssertionError('obs (f): no calibrated: rows')
    log(f'obs (f): diff run 1 run 2 --calibration --calibration-z '
        f'{CALIBRATION_Z}: rc 0, ' + ', '.join(
            f'{m} {rows[m]["b"]}' for m in calibrated))

    cpu = _tiny_pf(tmp, 'pf_cpu', cpu=cpu_run)
    dense = _launched(runs[0])
    want = {f'dispatch[{k}]' for k in dense}
    # The CPU's plain routing builds no records: that decision is absent
    # from its ledger, which the gate counts as lost too. Under
    # --allow-kernel-fallback the step rows (the CPU's steps against the
    # card's launches) may still fail: any exit code.
    for flags, status, want_rc in (((), 'REGRESSION', 1),
                                   (('--allow-kernel-fallback',), 'note',
                                    None)):
        rows = _diff_rows(f'obs (f) CPU against the card {flags}', want_rc,
                          runs[0], cpu, *flags)
        got = {m: (r['b'], r['status']) for m, r in rows.items()
               if m.startswith('dispatch[')}
        if not flags:
            outcomes = {m: b for m, (b, _) in got.items()}
        plain = {m[9:-1] for m, (b, _) in got.items() if b == 'plain'}
        skipped = {m: rows[m]['note'] for m in ('peak_memory_bytes',
                                                'idle_fraction')}
        if set(got) != want or any(b not in ('plain', 'absent')
                                   or st != status
                                   for b, st in got.values()) \
                or not {'consensus_fwd', 'spline_route_fwd',
                        'spline_route_bwd', 'rng'} <= plain \
                or any(rows[m]['status'] != 'skipped'
                       or n != 'sources differ (device vs host)'
                       for m, n in skipped.items()):
            raise AssertionError(f'obs (f): CPU candidate: dispatch rows '
                                 f'{got}, expected {sorted(want)} '
                                 f'{status}; {skipped}')
    rows = _diff_rows('obs (f) the card against the CPU', None, cpu,
                      runs[0])
    back = [m for m, r in rows.items()
            if m.startswith('dispatch[') and r['status'] == 'REGRESSION']
    if back:
        raise AssertionError(f'obs (f): card against CPU: {back}')
    log(f'obs (f): the tiny run with --device cpu against the card\'s run '
        f'1: rc 1, REGRESSION {dict(sorted(outcomes.items()))} (the '
        f'candidate\'s outcome), note under --allow-kernel-fallback; '
        f'peak_memory_bytes '
        f'and idle_fraction skipped (sources differ: device vs host); '
        f'reversed, no dispatch regression')
    log(f'obs (f): in {time.perf_counter() - t0:.1f}s; the readers\' '
        f'seconds ' + ', '.join(f'{k} {v:.4f}'
                               for k, v in sorted(READER_S.items())))


def phase_obs(smi_line):
    """The run plane on the card (``dgmc_tpu_torch/obs``):

    (a) ``dbp15k.main`` at full width (synthetic 15000 / 20000 entities,
    bf16, blocked adjacency), 13 epochs of which 10 of phase 1, with
    ``--obs-dir --obs-port 0 --probes --watchdog-deadline --slo
    --metrics_log`` (the launch counters at 0 just before it, every step
    and eval at ``KG_PER``'s counts): after each step ``/healthz``,
    ``/metrics`` and ``/status`` answer 200, the step histogram and
    ``/status`` count the steps taken; after it every artifact with JAX's
    top-level keys (:data:`OBS_KEYS`), each phase-2 step's probe series
    complete (``corr_entropy`` 2 + L, ``topk_mass`` 2,
    ``consensus_delta`` L, ``grad_norm`` 1; ``nonfinite`` 4 + L), one
    capture per step function and none after;
    (b) the captured KG phase-2 step and PascalPF step under each policy:
    an observer with probes off changes no output bit and no launch; with
    probes on the captured step's tape equals the eager step's bit for
    bit (:func:`_obs_variants`);
    (c) ``pascal_pf.main --profile-dir --profile-steps 1:3``: the trace
    names the steps and the port's kernels;
    (d) the run in (a) has ``--guard-bad-steps 1 --inject-fault
    nan-grads@12``: the first offender is ``grad`` at step 11 (optimizer
    step 12) and ``flight.json`` is dumped at the rollback; a device-side
    stall makes ``/healthz`` answer 503 and writes ``hang_report.json``
    (:func:`_obs_stall`);
    (e) the observer's cost on the captured bf16 KG phase-2 step, three
    ways (:func:`_obs_cost`);
    (f) the run-comparison readers (:func:`_obs_readers`): ``aggregate``
    over (a)'s dir (one host, one device, step-time ratio 1.0, read back
    by the report), ``diff`` of (a) against itself (an ``ok`` row for
    each gated key and each kernel launched; rc 1, its one regression
    ``first_nonfinite``: (a)'s poisoned step), ``calibrate`` over
    three tiny observed PascalPF runs on the card (the JAX CI's flags)
    and the calibrated ``diff`` of run 1 against run 2 (rc 0,
    ``calibrated:`` rows), the same run with ``--device cpu`` against run
    1 (a ``dispatch[...]`` regression per kernel, notes under
    ``--allow-kernel-fallback``, memory and idle skipped) and reversed
    (no dispatch regression)."""
    import tempfile
    # ``lint`` (f)'s ranks start here, beside this phase's host-bound
    # work; ``lint`` joins them.
    _lint_mesh_start()
    with tempfile.TemporaryDirectory() as tmp:
        # (f)'s run on the CPU, a process of its own, goes beside (a)-(e).
        cpu_run = _start_cpu_pf(tmp, 'pf_cpu')
        try:
            _obs_kg(tmp)
            gc.collect()
            torch.cuda.empty_cache()
            for policy in ('f32', 'bf16'):
                runs, observers = _obs_variants(
                    'KG phase 2', lambda jit: kg_step(policy, jit=jit), 2,
                    policy)
                if policy == 'bf16':
                    _obs_cost(runs, observers, smi_line)
                for obs in observers:
                    obs.close()
                _, observers = _obs_variants(
                    'PascalPF', lambda jit: dense_step(policy, jit), 2,
                    policy)
                for obs in observers:
                    obs.close()
                gc.collect()
                torch.cuda.empty_cache()
            _obs_profile(tmp)
            _obs_stall(tmp)
            _obs_readers(tmp, cpu_run)
        finally:
            if cpu_run.poll() is None:
                cpu_run.kill()
            cpu_run.wait()


#: The worker's configuration in the ``serve_worker`` phase: the DBP15K
#: widths (ψ₁ RelCNN 300 → 256, ψ₂ 32 → 32, 3 layers, k = 10, 10 steps),
#: float32, the three query buckets.
WORKER_FLAGS = ['--dim', '256', '--rnd_dim', '32', '--num_layers', '3',
                '--num_steps', '10', '--k', '10', '--max-results', '5',
                '--buckets', '16x48,32x96,64x192', '--seed', '0',
                '--obs-port', '0', '--watchdog-deadline', '15',
                '--restart-backoff', '0.5']
#: Query sizes of the ``serve_worker`` phase, three a bucket.
WORKER_NODES = (10, 13, 16, 20, 27, 32, 40, 51, 64)
#: The resume phase's uninterrupted run, for the supervised DBP15K run of
#: the ``serve_worker`` phase: its step-6 payload and last eval line.
RESUME_A = {}
#: What the worker answers beside the engine's answer (trace and timing).
WORKER_TRACE_KEYS = ('latency_ms', 'client_ms', 'trace_id', 'trace_ms',
                     'stages_ms', 'server_traceparent')


def _parse_exposition(text):
    """The Prometheus text format, strictly: ``{family: {'type',
    'samples': [(name, labels, value)]}}``; raises on any line outside
    the grammar."""
    if not text.endswith('\n'):
        raise AssertionError('exposition must end with a newline')
    fams, name_re = {}, r'[a-zA-Z_:][a-zA-Z0-9_:]*'
    for line in text.split('\n')[:-1]:
        m = re.fullmatch(rf'# (HELP|TYPE) ({name_re}) (.*)', line)
        if m:
            fam = fams.setdefault(m.group(2), {'type': None, 'samples': []})
            if m.group(1) == 'TYPE':
                if m.group(3) not in ('counter', 'gauge', 'histogram'):
                    raise AssertionError(f'bad type: {line!r}')
                fam['type'] = m.group(3)
            continue
        m = re.fullmatch(rf'({name_re})(?:\{{(.*)\}})? (\S+)', line)
        if not m:
            raise AssertionError(f'bad sample line: {line!r}')
        labels = dict(re.findall(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|'
                                 r'\\.)*)"', m.group(2) or ''))
        value = float(m.group(3))
        base = re.sub(r'_(bucket|sum|count)$', '', m.group(1))
        fam = fams.get(base) or fams.get(m.group(1))
        if fam is None or fam['type'] is None:
            raise AssertionError(f'sample without TYPE: {line!r}')
        fam['samples'].append((m.group(1), labels, value))
    return fams


def _worker_strip(answer):
    return {k: v for k, v in answer.items() if k not in WORKER_TRACE_KEYS}


def _worker_ready(obs, attempt, proc, probe, timeout_s=300):
    """Wait for attempt ``attempt`` of the supervised worker under
    ``obs`` to answer ``probe`` with 200 → ``(port, pid, gauges,
    codes)``, ``codes`` the ``/match`` codes seen while it warmed."""
    from dgmc_tpu_torch.serve.client import get_json, post_match
    hb_path = os.path.join(obs, f'attempt_{attempt}', 'heartbeat.json')
    codes, deadline = [], time.time() + timeout_s
    while time.time() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f'the supervisor exited {proc.returncode}')
        try:
            with open(hb_path) as f:
                hb = json.load(f)
        except (OSError, ValueError):
            hb = {}
        if hb.get('port'):
            res = post_match(hb['port'], probe, timeout_s=60)
            if res is not None:
                codes.append((res[0], res[1].get('error')))
                if res[0] == 200:
                    _, health = get_json(hb['port'], '/healthz')
                    return hb['port'], hb['pid'], health['gauges'], codes
        time.sleep(0.1)
    raise AssertionError(f'attempt {attempt} was not ready in {timeout_s}s')


def _worker_answers(port, payloads, label, want):
    """POST each payload; every answer equal to ``want``'s bit for bit
    (less the trace and timing fields) → the answers."""
    from dgmc_tpu_torch.serve.client import post_match
    got = []
    for i, p in enumerate(payloads):
        code, ans = post_match(port, p, timeout_s=60)
        if code != 200 or _worker_strip(ans) != want[i]:
            raise AssertionError(f'{label}: query {i} answered {code}, '
                                 f'not the in-process engine\'s answer')
        got.append(ans)
    return got


def _worker_inprocess(ckpt, corpus, payloads, graphs):
    """The in-process engine over the worker's checkpoint (the ``serve``
    phase's path, with the audit's host table), its answers to
    ``graphs``, and a worker shell around it that drives the service's
    ``/match`` handler in this process: the two 503s and the 500 that no
    live worker gives, and the shadow audit on the card (every query
    audited; recall must be 1.0)."""
    import argparse
    import tempfile
    from dgmc_tpu_torch.obs import RunObserver
    from dgmc_tpu_torch.serve.audit import ShadowAuditor
    from dgmc_tpu_torch.serve.cli import dbp15k_model
    from dgmc_tpu_torch.serve.corpus import load_or_build
    from dgmc_tpu_torch.serve.engine import MatchEngine
    from dgmc_tpu_torch.serve.router import QueryRouter
    from dgmc_tpu_torch.serve.service import ServeService, add_serve_args
    from dgmc_tpu_torch.train.checkpoint import Checkpointer
    model = dbp15k_model(seed=1)
    Checkpointer(ckpt).restore(model)
    index, _ = load_or_build(None, copy.deepcopy(model.psi_1), corpus,
                             device='cuda')
    engine = MatchEngine(model, index, QueryRouter(
        '16x48,32x96,64x192', corpus.num_nodes, corpus.num_edges),
        max_results=5, device='cuda', audit=True)
    engine.warm()
    want = []
    for g in graphs:
        ans = engine.match(g)
        ans.pop('_audit')
        want.append(ans)
    parser = argparse.ArgumentParser()
    add_serve_args(parser)
    with tempfile.TemporaryDirectory() as tmp:
        svc = ServeService(parser.parse_args(
            ['--ckpt_dir', ckpt, '--obs-dir', tmp, '--device', 'cuda']))
        svc.obs = RunObserver(tmp)
        svc.engine, svc.ready = engine, True
        svc.auditor = ShadowAuditor(engine, svc.obs.quality, 1.0)
        body = json.dumps(payloads[0]).encode()
        codes = {}
        for p in payloads:
            code, ans, _ = svc.handle_match('POST', json.dumps(p).encode())
            if code != 200:
                raise AssertionError(f'worker shell: {code} {ans}')
        svc.ready = False
        codes['warming-503'] = svc.handle_match('POST', body)[:2]
        svc.ready = True
        saved = dict(engine._exec)
        engine._exec.clear()
        codes['bucket-not-warm-503'] = svc.handle_match('POST', body)[:2]
        engine._exec.update(saved)
        match = engine.match

        def boom(*_a, **_k):
            raise RuntimeError('injected engine fault')
        engine.match = boom
        codes['engine-500'] = svc.handle_match('POST', body)[:2]
        engine.match = match
        if not svc.auditor.drain(timeout_s=120):
            raise AssertionError('worker shell: the audit did not drain')
        audit = svc.obs.quality.payload()['serve']['audit']
        svc.auditor.close()
        svc.obs.close()
    for cls, (code, payload) in codes.items():
        if (code, payload.get('error')) != {
                'warming-503': (503, 'warming-up'),
                'bucket-not-warm-503': (503, 'bucket-not-warm'),
                'engine-500': (500, 'engine-fault')}[cls]:
            raise AssertionError(f'worker shell: {cls} gave {code} '
                                 f'{payload}')
    if audit['audited'] != len(payloads) or audit['recall_min'] != 1.0 \
            or svc.auditor.errors:
        raise AssertionError(f'worker shell: audit {audit}')
    log(f'serve_worker: the worker shell in this process: warming-503, '
        f'bucket-not-warm-503 and engine-500 structured; the shadow audit '
        f'on its own stream, {audit["audited"]} queries audited, recall@10 '
        f'min {audit["recall_min"]}')
    return engine, want


def _worker_latency(port, engine, corpus, smi_line):
    """``/match`` latency over 100 new queries a bucket through HTTP
    (client round trip, the worker's ``latency_ms``, its
    ``device_execute`` span), beside the in-process engine's
    ``last_latency_s`` for the same queries."""
    from dgmc_tpu_torch.serve.client import (post_match, query_payload,
                                             sample_query)

    def pct(xs):
        xs = sorted(xs)
        return (f'p50 {statistics.median(xs):.3f} p99 '
                f'{xs[min(len(xs) - 1, int(0.99 * len(xs)))]:.3f}')

    for lo, hi in ((10, 16), (17, 32), (33, 64)):
        rows = collections.defaultdict(list)
        for i in range(100):
            n = lo + i % (hi - lo + 1)
            g, _ = sample_query(corpus.x, n, 3 * n, seed=10_000 + 100 * hi
                                + i)
            code, ans = post_match(port, query_payload(g), timeout_s=60)
            if code != 200:
                raise AssertionError(f'latency: {code} {ans}')
            rows['client'].append(ans['client_ms'])
            rows['server'].append(ans['latency_ms'])
            rows['device_execute'].append(ans['stages_ms']['device_execute'])
            engine.match(g)
            rows['engine'].append(engine.last_latency_s * 1e3)
        log(f'serve_worker: bucket {ans["bucket"]} ({lo}-{hi} nodes, 100 '
            f'queries, ms): HTTP round trip {pct(rows["client"])}; the '
            f'worker\'s latency_ms {pct(rows["server"])}; its '
            f'device_execute span {pct(rows["device_execute"])}; the '
            f'in-process engine\'s last_latency_s {pct(rows["engine"])} '
            f'on {smi_line}')


def _worker_dispatch(attempt_dir):
    """The worker's ``dispatch.json``: every gate on ``kernel``, top-k
    and the sparse consensus forward launched → launches by kernel."""
    with open(os.path.join(attempt_dir, 'dispatch.json')) as f:
        rows = [r for r in json.load(f)['counts'] if r['kernel'] != 'collate']
    per = collections.defaultdict(int)
    for r in rows:
        if r['outcome'] != 'kernel':
            raise AssertionError(f'serve_worker (a): {r}')
        per[r['kernel']] += r['count']
    if not per.get('topk') or not per.get('sparse_consensus_fwd'):
        raise AssertionError(f'serve_worker (a): dispatch {rows}')
    return per


def _worker_events(obs, attempt):
    """The worker's ``serve_ready`` record of attempt ``attempt``."""
    for rec in _read_jsonl(os.path.join(obs, f'attempt_{attempt}',
                                        'metrics.jsonl')):
        if rec.get('event') == 'serve_ready':
            return rec
    raise AssertionError(f'attempt {attempt}: no serve_ready record')


def phase_serve_worker(smi_line):
    """The serving worker and the supervisor on the card
    (``python -m dgmc_tpu_torch.serve --supervise``, the DBP15K widths,
    float32, buckets ``16x48,32x96,64x192``, the target KG of the
    synthetic DBP15K alignment as the corpus through ``--corpus-npz``,
    ``--init-missing``):

    (a) answer: the in-process engine over the worker's checkpoint answers
    nine queries (three a bucket); through HTTP each answer equals it bit
    for bit, repeats too, and 4 concurrent clients x the 9 queries give
    the sequential answers; the error classes a live worker gives (405,
    bad-query and bucket-miss 400s, ``warming-up`` 503 while it warms)
    and, through the service's handler in this process, the other three;
    ``/metrics`` strict-parsed with every class; ``/status`` with
    ``qtrace`` and ``capacity``; the worker's ``dispatch.json``: top-k and
    the sparse consensus forward on ``kernel`` and launched (per query);
    the shadow audit on the card (the handler's, recall 1.0); latency
    over 100 queries a bucket;
    (b) crash: SIGKILL the worker; the supervisor restarts it, the new
    worker reports ``corpus_cache_hit`` 1 and answers (a)'s queries bit
    for bit; ``recovery.json`` holds the crash and the restart;
    (c) hang: SIGSTOP the worker (watchdog deadline 15 s); the supervisor
    kills it as stale and the restarted worker answers again;
    (d) stop: SIGTERM the supervisor: it and its worker exit cleanly
    (128 + 15, outcome ``preempted``), ``qtrace.jsonl``,
    ``capacity.json`` and ``quality.json`` on disk, and the monitor never
    created a CUDA context;
    (e) ``dbp15k --supervise`` cut as the ``resume`` phase cuts it, with
    ``sigkill@5``: one crash, one restart, the fault fired once, its
    step-6 checkpoint and last eval line bit-identical to the resume
    phase's uninterrupted run; its child runs beside (c)'s wait;
    (f) ``diff`` of the worker's dir against itself with the serve gates
    armed (rc 0, the qtrace stage, goodput and utilization rows ``ok``),
    and of (e)'s supervised run against its completed attempt read alone
    (rc 1, ``restarts`` the one regression) (:func:`_worker_diffs`).

    Prints cold and warm ``ready_s`` with their phases, the latencies and
    the seconds from a kill to the restarted worker's first answer,
    beside the card's name and power limit."""
    import tempfile
    from dgmc_tpu_torch.serve.cli import dbp15k_kg
    from dgmc_tpu_torch.serve.client import (get_json, post_match,
                                             query_payload, sample_query)
    from dgmc_tpu_torch.serve.corpus import Corpus
    from dgmc_tpu_torch.serve.service import ERROR_CLASSES
    kg = dbp15k_kg(seed=0)
    corpus = Corpus(kg.x_t, kg.senders_t, kg.receivers_t)
    graphs = [sample_query(corpus.x, n, 3 * n, seed=500 + i)[0]
              for i, n in enumerate(WORKER_NODES)]
    payloads = [query_payload(g) for g in graphs]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get('PYTHONPATH')] if p]))
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, 'corpus.npz')
        np.savez(npz, x=corpus.x, senders=corpus.senders,
                 receivers=corpus.receivers)
        ckpt, obs = os.path.join(tmp, 'ckpt'), os.path.join(tmp, 'obs')
        argv = ['--supervise', '--ckpt_dir', ckpt, '--init-missing',
                '--corpus-npz', npz, '--obs-dir', obs] + WORKER_FLAGS
        monitor = ('import json, sys, torch\n'
                   'from dgmc_tpu_torch.serve.service import main\n'
                   'rc = main(sys.argv[1:])\n'
                   'print(json.dumps({"monitor_cuda_initialized": '
                   'torch.cuda.is_initialized()}), flush=True)\n'
                   'sys.exit(rc)\n')
        logs = open(os.path.join(tmp, 'supervisor.log'), 'w+')
        t_spawn = time.perf_counter()
        proc = subprocess.Popen([sys.executable, '-c', monitor] + argv,
                                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                stderr=logs, text=True)
        side = []
        try:
            # (a) answer
            port, pid, gauges, warming = _worker_ready(obs, 0, proc,
                                                       payloads[0])
            cold = _worker_events(obs, 0)
            log(f'serve_worker (a): cold start, spawn to the first answer '
                f'{time.perf_counter() - t_spawn:.1f}s; ready_s '
                f'{cold["ready_s"]} (corpus {cold["corpus_s"]}, checkpoint '
                f'{cold["checkpoint_s"]}, cache {cold["cache_s"]} '
                f'[{cold["cache"]}], warm {cold["warm_s"]} of which '
                f'captures {cold["capture_s"]}), /match codes while it '
                f'warmed {sorted(set(warming))} on {smi_line}')
            if gauges['corpus_cache_hit'] != 0 \
                    or gauges['serve_buckets_warm'] != 3:
                raise AssertionError(f'serve_worker (a): gauges {gauges}')
            engine, want = _worker_inprocess(ckpt, corpus, payloads, graphs)
            first = _worker_answers(port, payloads, '(a)', want)
            _worker_answers(port, payloads, '(a) repeat', want)
            with concurrent.futures.ThreadPoolExecutor(4) as pool:
                rounds = list(pool.map(
                    lambda _: [_worker_strip(post_match(port, p)[1])
                               for p in payloads], range(4)))
            if any(r != want for r in rounds):
                raise AssertionError('serve_worker (a): concurrent clients '
                                     'differ from the sequential answers')
            if sorted({b['bucket'] for b in first}) \
                    != ['16x48', '32x96', '64x192']:
                raise AssertionError('serve_worker (a): buckets not all hit')
            errors = {
                'method-405': get_json(port, '/match'),
                'bad-query-400': post_match(port, {'nodes': 'nope'}),
                'bucket-miss-400': post_match(port, query_payload(
                    sample_query(corpus.x, 100, 300, seed=1)[0]))}
            if [c for c, _ in errors.values()] != [405, 400, 400] or \
                    errors['bucket-miss-400'][1]['error'] != 'unknown-bucket':
                raise AssertionError(f'serve_worker (a): errors {errors}')
            code, text = get_json(port, '/metrics')
            fams = _parse_exposition(text)
            classes = {lab['class']: v for _, lab, v in
                       fams['dgmc_query_errors_total']['samples']}
            if set(classes) != set(ERROR_CLASSES) or any(
                    classes[c] < 1 for c in errors) or \
                    (503, 'warming-up') in warming and \
                    classes['warming-503'] < 1:
                raise AssertionError(f'serve_worker (a): classes {classes}')
            _, status = get_json(port, '/status')
            if not {'qtrace', 'capacity'} <= set(status) or \
                    status['capacity']['queries'] < 4 * len(payloads):
                raise AssertionError('serve_worker (a): /status lacks '
                                     'qtrace or capacity')
            _worker_latency(port, engine, corpus, smi_line)
            _, health = get_json(port, '/healthz')
            served = health['gauges']['queries_served']
            get_json(port, '/status')
            time.sleep(6)       # the idle loop's flush (every 5 s)
            per = _worker_dispatch(os.path.join(obs, 'attempt_0'))
            per_query = {k: round(per[k] / served, 3) for k in
                         ('topk', 'sparse_consensus_fwd', 'rng') if k in per}
            cap = status['capacity']
            # The goodput ratio weighted by each bucket's counted stage
            # FLOPs (the engine's count at warm), on disk as live.
            with open(os.path.join(obs, 'attempt_0', 'capacity.json')) as f:
                disk = json.load(f)
            sources = {b: v.get('stages_source')
                       for b, v in disk['buckets'].items()}
            if set(sources.values()) != {'counted'} \
                    or not 0 < disk['goodput_ratio'] <= 1:
                raise AssertionError(f'serve_worker (a): capacity.json '
                                     f'goodput {disk["goodput_ratio"]}, '
                                     f'stage tables {sources}')
            log(f'serve_worker (a): {served} queries served; the worker\'s '
                f'dispatch.json: launches a query {per_query}, all of its '
                f'launches (the corpus table\'s build included) '
                f'{dict(sorted(per.items()))}; capacity: saturation '
                f'{cap["saturation_qps"]} QPS, mean service '
                f'{cap["mean_service_ms"]} ms; capacity.json goodput ratio '
                f'{disk["goodput_ratio"]} (FLOP-weighted: {sources})')

            # (b) crash
            os.kill(pid, signal.SIGKILL)
            t_kill = time.perf_counter()
            port, pid, gauges, _ = _worker_ready(obs, 1, proc, payloads[0])
            to_answer = time.perf_counter() - t_kill
            warm = _worker_events(obs, 1)
            if gauges['corpus_cache_hit'] != 1 or warm['cache'] != 'hit':
                raise AssertionError(f'serve_worker (b): gauges {gauges}')
            _worker_answers(port, payloads, '(b)', want)
            with open(os.path.join(obs, 'recovery.json')) as f:
                rec = json.load(f)
            if [a.get('reason') for a in rec['attempts'][:1]] \
                    != ['signal:SIGKILL'] or 'restart' not in \
                    [e['event'] for e in rec['events']]:
                raise AssertionError(f'serve_worker (b): {rec["events"]}')
            log(f'serve_worker (b): SIGKILL to the first answer of the '
                f'restarted worker {to_answer:.1f}s; warm ready_s '
                f'{warm["ready_s"]} (cache {warm["cache_s"]} [hit], warm '
                f'{warm["warm_s"]} of which captures {warm["capture_s"]}); '
                f'the answers bit-identical on {smi_line}')

            # (c) hang; (e)'s child runs beside its wait (the
            # supervisor's stale verdict is a fixed 2 x 15 s + 10 s).
            if not RESUME_A:
                raise AssertionError('serve_worker (e): the resume phase '
                                     'left no uninterrupted run to compare '
                                     'with')
            side = [_supervised_kg(tmp, env)]
            os.kill(pid, signal.SIGSTOP)
            t_stop = time.perf_counter()
            port, pid, gauges, _ = _worker_ready(obs, 2, proc, payloads[0])
            to_answer = time.perf_counter() - t_stop
            _worker_answers(port, payloads, '(c)', want)
            with open(os.path.join(obs, 'recovery.json')) as f:
                rec = json.load(f)
            reason = rec['attempts'][1].get('reason')
            if reason not in ('healthz-stale', 'heartbeat-stale'):
                raise AssertionError(f'serve_worker (c): attempt 1 {reason}')
            log(f'serve_worker (c): SIGSTOP killed as {reason}; stop to the '
                f'first answer of the restarted worker {to_answer:.1f}s '
                f'(deadline 15 s, stale at 2x, 10 s SIGTERM grace; (e) '
                f'running beside it)')
        except BaseException:
            for p in side:
                p.kill()
                p.wait()
            raise
        finally:
            # (d) stop
            proc.send_signal(signal.SIGTERM)
            try:
                out, _ = proc.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, _ = proc.communicate()
            logs.seek(0)
            for line in logs.read().splitlines()[-40:]:
                log(f'  | {line}')
            logs.close()
        if proc.returncode != 128 + signal.SIGTERM or \
                '"monitor_cuda_initialized": false' not in out:
            raise AssertionError(f'serve_worker (d): the supervisor exited '
                                 f'{proc.returncode}, {out!r}')
        with open(os.path.join(obs, 'recovery.json')) as f:
            rec = json.load(f)
        last = os.path.join(obs, f'attempt_{len(rec["attempts"]) - 1}')
        missing = [n for n in ('qtrace.jsonl', 'capacity.json',
                               'quality.json')
                   if not os.path.exists(os.path.join(last, n))]
        if rec['outcome'] != 'preempted' or missing:
            raise AssertionError(f'serve_worker (d): outcome '
                                 f'{rec["outcome"]}, missing {missing}')
        log(f'serve_worker (d): SIGTERM: exit 143, outcome preempted, '
            f'{len(rec["attempts"])} attempts, the last worker\'s '
            f'artifacts on disk, the monitor without a CUDA context')
        for i in range(len(rec['attempts'])):
            path = os.path.join(obs, f'attempt_{i}', 'timings.json')
            if os.path.exists(path):
                with open(path) as f:
                    LINT_OBS[f'serve_worker attempt_{i}'] = f.read()

        # (e) the training CLI under supervision
        run_e, = side
        rc = run_e.wait(timeout=900)
        run_e.out.seek(0)
        out = run_e.out.read()
        run_e.out.close()
        with open(os.path.join(run_e.obs, 'recovery.json')) as f:
            rec = json.load(f)
        if rc != 0 or [a['reason'] for a in rec['attempts']] \
                != ['signal:SIGKILL', 'completed'] or \
                out.count('[faults] firing sigkill@5') != 1:
            for line in out.splitlines()[-40:]:
                log(f'  | {line}')
            raise AssertionError(f'serve_worker (e): exit {rc}, attempts '
                                 f'{rec["attempts"]}')
        from dgmc_tpu_torch.train.checkpoint import STATE_FILE
        got = torch.load(os.path.join(run_e.ckpt, '6', STATE_FILE),
                         map_location='cpu', weights_only=True)
        n = _hold_checkpoints('serve_worker (e): E step 6 against resume A '
                              'step 6', RESUME_A['payload'], got)
        if _eval_lines(out)[-1] != RESUME_A['eval']:
            raise AssertionError('serve_worker (e): last eval line differs')
        done_s = os.path.getmtime(os.path.join(run_e.obs,
                                               'recovery.json')) - run_e.t0
        log(f'serve_worker (e): dbp15k --supervise, sigkill@5 fired once, '
            f'one restart, done in {done_s:.1f}s (beside (c)); step 6 '
            f'bit-identical to the resume phase\'s uninterrupted run ({n} '
            f'tensors), last eval line equal')
        _worker_diffs(obs, run_e.obs)


def _worker_diffs(obs, kg_obs):
    """(f): ``diff`` of the worker's supervised dir against itself with
    the serve gates armed; ``diff`` of (e)'s supervised run against its
    completed attempt's dir read alone (the CLI's artifacts without the
    supervisor's ``recovery.json``, as an unsupervised run leaves them)."""
    t0 = time.perf_counter()
    rows = _diff_rows('serve_worker (f) the worker against itself', 0, obs,
                      obs, '--max-stage-p95-regression', '0.5',
                      '--min-goodput', '0', '--max-utilization', '1.0')
    stages = sorted(m for m in rows if m.startswith('qtrace['))
    need = stages + ['goodput_ratio', 'utilization', 'restarts']
    bad = {m: rows.get(m) for m in need
           if (rows.get(m) or {}).get('status') != 'ok'}
    if not stages or bad:
        raise AssertionError(f'serve_worker (f): worker diff rows '
                             f'{bad or sorted(rows)}')
    with open(os.path.join(kg_obs, 'recovery.json')) as f:
        last = len(json.load(f)['attempts']) - 1
    alone = os.path.join(kg_obs, f'attempt_{last}')
    rows = _diff_rows('serve_worker (f) supervised KG against its attempt',
                      1, alone, kg_obs)
    failed = {m: (r['a'], r['b']) for m, r in rows.items()
              if r['status'] == 'REGRESSION'}
    if failed != {'restarts': (0, 1)}:
        raise AssertionError(f'serve_worker (f): regressions {failed}, '
                             f'expected restarts 0 -> 1 alone')
    log(f'serve_worker (f): diff of the worker\'s dir against itself with '
        f'the serve gates: rc 0, ok rows {need}; dbp15k --supervise (e) '
        f'against its attempt_{last} read alone: rc 1, the one regression '
        f'restarts 0 -> 1; in {time.perf_counter() - t0:.3f}s')


def _supervised_kg(tmp, env):
    """(e)'s child: ``dbp15k --supervise`` cut as the ``resume`` phase
    cuts it, with ``sigkill@5``; its output to a file."""
    out = open(os.path.join(tmp, 'kg.log'), 'w+')
    ckpt, obs = os.path.join(tmp, 'E'), os.path.join(tmp, 'O')
    proc = subprocess.Popen(
        [sys.executable, '-m', 'dgmc_tpu_torch.experiments.dbp15k',
         '--supervise', '--restart-backoff', '0.5', *KG_ARGV, *F32_ARGV,
         *RESUME_ARGV, '--ckpt_dir', ckpt, '--obs-dir', obs,
         '--inject-fault', 'sigkill@5'],
        cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT, text=True)
    proc.out, proc.ckpt, proc.obs = out, ckpt, obs
    proc.t0 = time.time()
    return proc


#: The ``lint`` phase's (c): a step whose captured function reads the
#: device from the host (written to a file, imported, and linted there).
LINT_SYNC_SRC = """\
from dgmc_tpu_torch.train.compiled import compiled


def scaled(x):
    total = x.sum()
    return x * total.item()


step = compiled(scaled, 'cuda')
"""


#: The hazard steps of ``lint`` (d): a host read and a float
#: accumulation through atomics, run on the card under the trace tier's
#: tape.
LINT_TRACE_SRC = """\
import torch


def scaled(x):
    total = x.sum()
    return x * total.item()


def pooled(x, index):
    out = torch.zeros(4, x.shape[1], device=x.device)
    return out.index_add_(0, index, x)
"""

#: The kernels each trace-tier specimen must launch on the card
#: (``PERF.md``'s kernel table: the TPU kernels "on this slice's path").
SPECIMEN_KERNELS = {
    'forward_dense': ('consensus_fwd',),
    'forward_sparse_k3': ('topk', 'sparse_consensus_fwd'),
    'train_step_dense': ('consensus_fwd',),
    'train_step_sparse_k3': ('topk', 'sparse_consensus_fwd',
                             'sparse_consensus_bwd', 'rng'),
    'eval_step_dense': ('consensus_fwd',),
    'ops.chunked_topk_f32': ('topk',),
}


def _lint_trace(tmp, smi_line):
    """``lint`` (d): the trace tier over the eight specimens on the card,
    in this process (see :func:`phase_lint`). Returns its seconds."""
    from dgmc_tpu_torch.analysis import lint as lint_mod
    from dgmc_tpu_torch.analysis.registry import (default_specimens,
                                                  shared_cache)
    from dgmc_tpu_torch.analysis.trace_rules import (TapeRecorder,
                                                     TraceContext,
                                                     analyze_tape)
    baseline = os.path.join(ROOT, 'lint-baseline-torch.json')
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = lint_mod.main(['--json', '--fail-on', 'new', '--baseline',
                            baseline, '--skip-source', '--skip-concurrency',
                            '--device', 'cuda'])
    torch.cuda.synchronize()
    tier_s = time.perf_counter() - t0
    report = json.loads(buf.getvalue())
    rules = collections.Counter(f['rule'] for f in report['findings'])
    if rc != 0 or rules['TRC003'] or rules['TRC004']:
        new = set(report['new'])
        raise AssertionError(f'lint (d): rc {rc}, findings by rule '
                             f'{dict(rules)}, new: ' + '; '.join(
                                 f'{f["rule"]} {f["where"]} '
                                 f'({f["message"]}: {f.get("context")})'
                                 for f in report['findings']
                                 if f['fingerprint'] in new))
    cache = shared_cache('cuda')
    rows = []
    for spec in default_specimens():
        if spec.min_devices:
            continue       # (f)
        art = cache.artifacts(spec)
        rec = art.recorded()
        got = rec['launches']
        missing = [k for k in SPECIMEN_KERNELS.get(spec.name, ())
                   if not got.get(k)]
        if missing or art.stats['builds'] != 1 or art.stats['runs'] != 1:
            raise AssertionError(f'lint (d) {spec.name}: launches {got} '
                                 f'(none of {missing}), stats {art.stats}')
        rows.append(f'{spec.name} {dict(sorted(got.items())) or "none"} '
                    f'({len(rec["tape"].ops)} ops, run '
                    f'{rec["seconds"]:.3f}s)')
    log(f'lint (d): the trace tier over the 8 specimens on the card and '
        f'the SHD and SCH/MEM tiers over (f)\'s mesh runs in '
        f'{tier_s:.2f}s: rc 0 against lint-baseline-torch.json with '
        f'--fail-on new, findings by rule {dict(sorted(rules.items()))} '
        f'(no TRC003, no TRC004); launches by specimen: '
        + '; '.join(rows) + f' on {smi_line}')

    # Two hazard steps on the card.
    path = os.path.join(tmp, 'lint_trace_step.py')
    with open(f'{path}.tmp', 'w') as f:
        f.write(LINT_TRACE_SRC)
    os.replace(f'{path}.tmp', path)
    lines = LINT_TRACE_SRC.splitlines()
    want = {'TRC003': 1 + next(i for i, s in enumerate(lines)
                               if '.item()' in s),
            'TRC005': 1 + next(i for i, s in enumerate(lines)
                               if 'index_add_' in s)}
    spec = importlib.util.spec_from_file_location('lint_trace_step', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    x = torch.randn(8, 3, device='cuda')
    index = torch.randint(0, 4, (8,), device='cuda')
    got = {}
    for rule, fn, args in (('TRC003', mod.scaled, (x,)),
                           ('TRC005', mod.pooled, (x, index))):
        with TapeRecorder(args) as rec:
            fn(*args)
        found = analyze_tape(rec.tape, TraceContext(specimen='hazard'))
        got[rule] = [(f.rule, int(f.where.rsplit(':', 1)[1]))
                     for f in found]
        if got[rule] != [(rule, want[rule])]:
            raise AssertionError(f'lint (d) hazard {rule}: {got[rule]}, '
                                 f'expected line {want[rule]}')
    log(f'lint (d): hazard steps on the card: .item() -> '
        f'{got["TRC003"]}, index_add_ -> {got["TRC005"]}')
    return tier_s


def _lint_costs(tmp, smi_line):
    """``lint`` (e): ``obs.cost``'s specimen rows merged into the obs dir
    of a tiny observed PascalPF run (:func:`_tiny_pf`, on the card), and
    ``obs.diff --max-peak-regression`` over it (see :func:`phase_lint`).
    Returns its seconds."""
    from dgmc_tpu_torch.obs import cost as cost_mod
    from dgmc_tpu_torch.obs import diff as diff_mod
    from dgmc_tpu_torch.utils.io import write_json_atomic
    t0 = time.perf_counter()
    d = _tiny_pf(tmp, 'cost_obs')
    with open(os.path.join(d, 'efficiency.json')) as f:
        run_rows = set(json.load(f)['programs'])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cost_mod.main(['--obs-dir', d, '--json', '--device', 'cuda'])
    payload = json.loads(buf.getvalue())
    rows = {k[len('specimen.'):]: v for k, v in payload['programs'].items()
            if k.startswith('specimen.')}
    bad = [k for k, v in rows.items()
           if 'error' in v or not v.get('static_peak_bytes')
           or v.get('measured_peak_bytes') is None]
    if rc != 0 or len(rows) != 13 or bad or not run_rows or \
            not run_rows <= set(payload['programs']):
        raise AssertionError(f'lint (e): rc {rc}, rows {sorted(rows)}, '
                             f'bad {bad}: {payload}')
    peaks = '; '.join(
        f'{k} static {v["static_peak_bytes"]} B (arguments '
        f'{v["argument_bytes"]} B) against measured '
        f'{v["measured_peak_bytes"]} B above the arguments, '
        f'{v["flops"]} FLOP' for k, v in rows.items())
    raised = os.path.join(tmp, 'cost_obs_raised')
    shutil.copytree(d, raised)
    eff_path = os.path.join(raised, 'efficiency.json')
    with open(eff_path) as f:
        eff = json.load(f)
    for v in eff['programs'].values():
        if v.get('static_peak_bytes'):
            v['static_peak_bytes'] = int(v['static_peak_bytes'] * 1.5)
    write_json_atomic(eff_path, eff)
    out = {}
    for name, cand in (('itself', d), ('raised 50%', raised)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = diff_mod.main([d, cand, '--json',
                                '--max-peak-regression', '0.25'])
        row = [r for r in json.loads(buf.getvalue())['rows']
               if r['metric'] == 'static_peak_bytes']
        out[name] = (rc, row[0]['status'] if row else None)
    if out != {'itself': (0, 'ok'), 'raised 50%': (1, 'REGRESSION')}:
        raise AssertionError(f'lint (e): obs.diff --max-peak-regression '
                             f'{out}')
    seconds = time.perf_counter() - t0
    log(f'lint (e): python -m dgmc_tpu_torch.obs.cost --obs-dir (in this '
        f'process, the trace tier\'s runs) into a tiny PascalPF run\'s obs '
        f'dir (its rows {sorted(run_rows)} kept) in {seconds:.2f}s: '
        f'{peaks}; '
        f'obs.diff --max-peak-regression 0.25 against itself {out["itself"]}'
        f', against the copy raised 50% {out["raised 50%"]} on {smi_line}')
    return seconds


#: ``lint`` (f): the kernels each mesh specimen must launch on every rank
#: that runs it (the TPU kernels on this slice's path, ``PERF.md``).
MESH_KERNELS = {
    'parallel.sharded_train_step': ('consensus_fwd',),
    'parallel.sharded_forward_rows': ('consensus_fwd',),
    'parallel.sharded_train_step_pairs2': ('consensus_fwd',),
    'parallel.streamed_train_step': ('topk', 'sparse_consensus_fwd',
                                     'sparse_consensus_bwd', 'rng'),
    'parallel.sharded_topk_cols': ('topk',),
}
MESH_RANKS = 4
#: The ranks of ``lint`` (f), started by :func:`_lint_mesh_start`.
LINT_MESH = {}
#: Each phase's end on the host's wall clock (``lint`` (f) prints where
#: its ranks ended beside them).
PHASE_END = {}


def _mesh_hazard():
    """``lint`` (f)'s hazard: ``sharded_forward_rows`` with its S
    all-gathered whole over the rows' and the batch's groups."""
    from dgmc_tpu_torch.analysis import registry
    inner = registry._sharded_forward_rows_specimen()

    def build(device, inject=None):
        from dgmc_tpu_torch.parallel.comm import all_gather
        built = inner(device)
        forward = built['fn']

        def gathered(model, batch, noise_seed):
            mesh = model.corr_sharding.mesh
            _, S_L = forward(model, batch, noise_seed)
            rows = all_gather(S_L.val, mesh.group('model'), dim=1)
            return all_gather(rows, mesh.group('data'), dim=0)

        return dict(built, fn=gathered)
    return registry.Specimen('parallel.sharded_forward_rows_gather_S',
                             build, min_devices=4, tiers=('shd',))


def _lint_mesh_start(device='cuda'):
    """Start ``lint`` (f)'s ranks (they share the card) through the
    package's own launcher (``analysis/ranks.py``, as the lint CLI starts
    them), the hazard riding along, without waiting for them."""
    from dgmc_tpu_torch.analysis.registry import shared_cache
    runs = shared_cache(device).mesh_runs()
    LINT_MESH.update(run=runs.start(extra=('chip_smoke:_mesh_hazard',)),
                     runs=runs, device=device)


def _lint_mesh_join():
    """Wait for ``lint`` (f)'s ranks (starting them now if ``obs`` did
    not); their records stay in this process's specimen cache, so that
    the CLI's tiers read them: ``{'records', 'hazard', 'wall', 'ended',
    'device'}``, ``ended`` each rank's end on the host's wall clock."""
    if 'run' not in LINT_MESH:
        _lint_mesh_start()
    run = LINT_MESH['run']
    records = dict(LINT_MESH['runs'].wait())
    hazard = records.pop(_mesh_hazard().name)
    return {'records': records, 'hazard': hazard,
            'wall': max(run.ended) - run.started, 'ended': run.ended,
            'device': LINT_MESH['device']}


def _lint_mesh(mesh, smi_line):
    """``lint`` (f) (see :func:`phase_lint`). Returns its seconds."""
    from dgmc_tpu_torch.analysis.comm import collective_table
    from dgmc_tpu_torch.analysis.liveness import peak_summary
    from dgmc_tpu_torch.analysis.schedule import schedule_summary
    from dgmc_tpu_torch.analysis.shd_rules import (ShardedContext,
                                                   analyze_sharded_tape)
    t0 = time.perf_counter()
    rows = []
    for name, want in MESH_KERNELS.items():
        recs = mesh['records'].get(name) or []
        ran = 2 if name in ('parallel.sharded_train_step',
                            'parallel.sharded_topk_cols') else 4
        launches = [dict(sorted(r['launches'].items())) for r in recs]
        missing = [(r['rank'], k) for r in recs for k in want
                   if not r['launches'].get(k)]
        if mesh['device'] != 'cuda':
            missing = []    # a CPU rehearsal launches no kernel
        if len(recs) != ran or missing or any(
                r['device'] != mesh['device'] for r in recs):
            raise AssertionError(f'lint (f) {name}: {len(recs)} ranks, '
                                 f'launches {launches}, none of {missing}')
        tape = recs[0]['tape']
        sched = schedule_summary(tape)
        rows.append(f'{name} on {len(recs)} ranks: collectives '
                    f'{json.dumps(collective_table(tape)["ops"])}, '
                    f'overlap_fraction {sched.get("overlap_fraction")}, '
                    f'critical_path_share {sched["critical_path_share"]}, '
                    f'static peak '
                    f'{peak_summary(tape)["static_peak_bytes"]} B, '
                    f'launches by rank {launches}')
    haz = [r for r in mesh['hazard'] if r is not None]
    found = analyze_sharded_tape(
        [r['tape'] for r in haz],
        ShardedContext(specimen='hazard',
                       corr_bytes=haz[0]['budgets']['corr_bytes']))
    if len(haz) != MESH_RANKS or [f.rule for f in found] != ['SHD302']:
        raise AssertionError(f'lint (f) hazard: {len(haz)} ranks, findings '
                             f'{[(f.rule, f.where) for f in found]}')
    seconds = time.perf_counter() - t0
    started = LINT_MESH['run'].started
    beside = ', '.join(
        f'{name} ended at {PHASE_END[name] - started:.1f}s'
        for name in ('obs', 'serve_worker') if name in PHASE_END)
    log(f'lint (f): the five mesh specimens on {MESH_RANKS} gloo ranks '
        f'sharing the card, started with obs: the ranks ended '
        f'{", ".join(f"{e - started:.1f}" for e in mesh["ended"])}s after '
        f'their start ({beside}): ' + '; '.join(rows) + f'; the all-gathered-S variant of '
        f'sharded_forward_rows: {found[0].where} {found[0].message} '
        f'({found[0].detail}) on {smi_line}')
    return seconds


def phase_lint(smi_line):
    """The port's static analysis (``dgmc_tpu_torch/analysis``) on the
    card's machine, over what the earlier phases left:

    (a) ``python -m dgmc_tpu_torch.analysis.lint --json --skip-trace
    --fail-on new`` over this checkout (the trace tier runs in (d)) (the package and ``chip_smoke.py``), with the
    kernels' ``_build/`` present (and ``__pycache__`` dirs, where the
    interpreter writes bytecode), none of their files scanned: rc 0
    against ``lint-baseline-torch.json``;
    (b) the recompile pass (the CLI's RCP tier) over the KG obs dir of
    ``obs`` (a) and each worker attempt's dir of ``serve_worker``: the
    padding buckets, the compile events by kind (captures, ``nvcc``
    builds) and the findings; no RCP202. The build phase's ``nvcc``
    events (this checkout's cold ``_build/``) are printed beside, with
    the verdict RCP202 would give if the budget counted them;
    (c) SRC102 against the card: a few-line function that calls
    ``.item()``, passed to ``compiled(..., 'cuda')``: its capture raises
    (``sync_errors``) at the line that the SRC tier flags statically;
    (d) the trace tier over the eight specimens on the card, in this
    process (:func:`_lint_trace`): rc 0 against
    ``lint-baseline-torch.json`` with ``--fail-on new``, no TRC003 and no
    TRC004, each specimen built and run once, its kernel launches from
    the ledger printed and non-zero where :data:`SPECIMEN_KERNELS` says;
    then two hazard steps on the card, a ``.item()`` and an
    ``index_add_``, give TRC003 and TRC005 at their lines;
    (e) ``python -m dgmc_tpu_torch.obs.cost`` (its ``main``, sharing (d)'s
    runs) into the obs dir of a tiny observed PascalPF run on the card,
    its run rows kept (:func:`_lint_costs`): each specimen's
    ``static_peak_bytes`` printed
    beside the allocator's measured peak of its run; ``obs.diff
    --max-peak-regression`` passes on the dir against itself and fails on
    a copy whose static peaks are raised 50%.

    (f) the five mesh specimens on 4 gloo ranks sharing the card
    (:func:`_lint_mesh`; started at the start of ``obs``, joined first
    here, so that (d)'s CLI run reads them).

    Prints the phase's seconds beside the card's name and power limit."""
    import tempfile
    from dgmc_tpu_torch.analysis import lint as lint_mod
    from dgmc_tpu_torch.analysis.recompile import (analyze_buckets,
                                                   bucket_signature,
                                                   load_obs_buckets)
    from dgmc_tpu_torch.analysis.source_rules import (iter_source_files,
                                                      lint_source_file)
    from dgmc_tpu_torch.utils.io import write_json_atomic
    t_phase = time.perf_counter()
    mesh = _lint_mesh_join()
    # (a) the CLI over the checkout
    pkg = os.path.join(ROOT, 'dgmc_tpu_torch')
    built = os.listdir(os.path.join(pkg, '_build'))
    caches = [dp for dp, _, _ in os.walk(pkg)
              if os.path.basename(dp) == '__pycache__']
    scanned = list(iter_source_files(pkg))
    stray = [p for p in scanned
             if {'_build', '__pycache__'} & set(p.split(os.sep))]
    if not built or stray:
        raise AssertionError(f'lint (a): _build/ holds {len(built)} files; '
                             f'scanned from _build/ or __pycache__: '
                             f'{stray}')
    baseline = os.path.join(ROOT, 'lint-baseline-torch.json')
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, '-m', 'dgmc_tpu_torch.analysis.lint', '--json',
         '--skip-trace', '--skip-sharded', '--skip-sched', '--fail-on',
         'new', '--baseline', baseline],
        cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    cli_s = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f'lint (a): rc {out.returncode}: '
                             f'{out.stdout[-3000:]} {out.stderr[-2000:]}')
    report = json.loads(out.stdout)
    log(f'lint (a): python -m dgmc_tpu_torch.analysis.lint --json '
        f'--skip-trace --skip-sharded --skip-sched --fail-on new: rc 0 in '
        f'{cli_s:.2f}s over {len(scanned)} package '
        f'files and chip_smoke.py (_build/ with {len(built)} files and '
        f'{len(caches)} __pycache__ dirs skipped); summary '
        f'{report["summary"]}')

    with tempfile.TemporaryDirectory() as tmp:
        # (b) the recompile pass over the phases' obs dirs
        labels = sorted(LINT_OBS)
        if 'obs (a) KG' not in labels or not any(
                k.startswith('serve_worker') for k in labels):
            raise AssertionError(f'lint (b): obs dirs kept: {labels} (the '
                                 f'obs and serve_worker phases keep them)')
        nvcc_cold = BUILD_EVENTS.get('nvcc', 0)
        for i, label in enumerate(labels):
            d = os.path.join(tmp, f'obs_{i}')
            timings = json.loads(LINT_OBS[label])
            write_json_atomic(os.path.join(d, 'timings.json'), timings)
            kinds = timings['compile'].get('by_kind')
            buckets, captures = load_obs_buckets(d)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = lint_mod.main(['--json', '--skip-source',
                                    '--skip-concurrency', '--skip-trace',
                                    '--skip-sharded', '--skip-sched',
                                    '--obs-dir', d,
                                    '--baseline',
                                    os.path.join(tmp, 'none.json'),
                                    '--fail-on', 'none'])
            found = json.loads(buf.getvalue())['findings']
            rules = [f['rule'] for f in found]
            if rc != 0 or 'RCP202' in rules or kinds is None:
                raise AssertionError(f'lint (b) {label}: rc {rc}, '
                                     f'findings {found}, by_kind {kinds}')
            distinct = len({bucket_signature(b) for b in buckets}) or 1
            cold = analyze_buckets(buckets,
                                   compile_events=captures + nvcc_cold)
            rows = [(b['batch'], b['nodes'], b['edges'], b['count'])
                    for b in buckets]
            log(f'lint (b) {label}: buckets (B, nodes, edges, count) '
                f'{rows}; '
                f'compile events {kinds} -> {captures} captures for '
                f'{distinct} signature(s) ({captures / distinct:g} a '
                f'bucket, budget 8); findings {rules or "none"}; with '
                f'this checkout\'s cold-_build/ nvcc events added '
                f'({nvcc_cold}): {[f.rule for f in cold] or "none"}')
        log(f'lint (b): the build phase recorded {BUILD_EVENTS} (cold '
            f'_build/: one nvcc event a source); the obs dirs above were '
            f'written on a warm _build/')

        # (c) SRC102 against the card
        path = os.path.join(tmp, 'lint_sync_step.py')
        with open(f'{path}.tmp', 'w') as f:
            f.write(LINT_SYNC_SRC)
        os.replace(f'{path}.tmp', path)
        static = [(f.rule, int(f.where.rsplit(':', 1)[1]))
                  for f in lint_source_file(path)]
        if [r for r, _ in static] != ['SRC102']:
            raise AssertionError(f'lint (c): static findings {static}')
        spec = importlib.util.spec_from_file_location('lint_sync_step', path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        try:
            mod.step(torch.ones(4, device='cuda'))
        except RuntimeError as e:
            lines = [fr.lineno for fr in traceback.extract_tb(e.__traceback__)
                     if fr.filename == path]
            if lines[-1:] != [static[0][1]] or 'synchroniz' not in str(e):
                raise AssertionError(f'lint (c): the capture raised at '
                                     f'lines {lines}: {e}') from e
            raised = str(e).splitlines()[0]
        else:
            raise AssertionError('lint (c): a captured .item() did not '
                                 'raise')
        torch.cuda.synchronize()
        if mod.step.records:
            raise AssertionError('lint (c): the failed capture left a '
                                 'record')
        log(f'lint (c): compiled(scaled, \'cuda\') raised at line '
            f'{static[0][1]} ({raised!r}); the SRC tier flags the same '
            f'line statically: {static}')

        # (d) the trace tier on the card, (e) the specimen cost rows
        trace_s = _lint_trace(tmp, smi_line)
        cost_s = _lint_costs(tmp, smi_line)
        mesh_s = _lint_mesh(mesh, smi_line)
        log(f'lint: (d) {trace_s:.2f}s, (e) {cost_s:.2f}s, (f) '
            f'{mesh_s:.2f}s after the ranks\' {mesh["wall"]:.1f}s')
    log(f'lint: phase in {time.perf_counter() - t_phase:.2f}s on '
        f'{smi_line}')


#: The ``parallel`` phase's sizes: (b)'s search (B, N_s, N_t, C, k) and
#: the ranks sharing the card; (c)'s flags (full DBP15K width, float32,
#: the blocked aggregation on, 3 epochs into phase 2).
PAR_TOPK = TOPK_SHAPE
PAR_RANKS = 2
PAR_KG_ARGV = KG_ARGV + ['--f32', '--epochs', '3', '--phase1_epochs', '1',
                         '--blocked_adjacency', 'on']
#: (c)'s and (d)'s tolerance against the one-process run (the sums over
#: ranks are in another order): the loss within JAX's own bound
#: (``tests/parallel/test_sharding.py``), Hits within 2e-3.
PAR_LOSS_REL, PAR_HITS_ABS = 1e-4, 2e-3
PAR_KG_KERNELS = ('topk', 'sparse_consensus_fwd', 'sparse_consensus_bwd',
                  'blocked')
#: (d): ``pascal`` at the JAX CLI's widths on a small fixture tree
#: (``write_voc``: 4 training instances a category), one epoch of 16-pair
#: batches, float32, structure only (no images).
PAR_PASCAL_ARGV = ['--vgg_weights', 'none', '--epochs', '1', '--batch_size',
                   '16', '--test_samples', '20', '--f32']
PAR_PASCAL_KERNELS = ('spline_route_fwd', 'spline_route_bwd',
                      'consensus_fwd')
PASCAL_LOSS = re.compile(r'^Epoch: (\d+), Loss: ([\d.]+)')
EPOCH_LINE = re.compile(r'^(\d{3}): Loss: ([\d.]+), Hits@1: ([\d.]+), '
                        r'Hits@10: ([\d.]+)')


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def _par_inputs(dtype, device, shape):
    """(b)'s search inputs: the same on every rank (one seed, one card)."""
    B, N_s, N_t, C, _ = shape
    g = torch.Generator(device=device).manual_seed(23)
    h_s = torch.randn(B, N_s, C, generator=g, device=device)
    h_t = torch.randn(B, N_t, C, generator=g, device=device)
    return h_s.to(dtype), h_t.to(dtype)


def _par_topk_rank(rank, world, port, out_dir, device, shape):
    """(b) on one rank (run in a process of its own): rows and ring, each
    dtype, at ``shape`` (``(B, N_s, N_t, C, k)``); this rank's launches and
    host ms a search (median of 3, synchronized), rank 0's gathered
    indices saved beside."""
    from dgmc_tpu_torch.ops.kernels import dispatch
    from dgmc_tpu_torch.parallel import distributed, make_mesh
    from dgmc_tpu_torch.parallel.comm import all_gather
    from dgmc_tpu_torch.parallel.mesh import NamedSharding
    from dgmc_tpu_torch.parallel.topk import (corr_sharded_topk,
                                              sharded_topk_rows)
    if device == 'cuda':
        torch.cuda.set_device(0)
    k = shape[4]
    report = {}
    with distributed.process_group(f'127.0.0.1:{port}', world, rank,
                                   backend='gloo'):
        by_model = make_mesh(data=1, model=world, device=device)
        by_data = make_mesh(data=world, model=1, device=device)
        ring = NamedSharding(by_data, (None, 'data'))
        for dtype in (torch.float32, torch.bfloat16):
            h_s, h_t = _par_inputs(dtype, device, shape)
            calls = {
                'rows': lambda: sharded_topk_rows(by_model, h_s, h_t, k),
                'ring': lambda: corr_sharded_topk(ring, h_s, h_t, k, None,
                                                  ring=True)}
            for kind, fn in calls.items():
                dispatch.reset()
                block = fn()
                if device == 'cuda':
                    torch.cuda.synchronize()
                launches = dispatch.launch_counts().get('topk', 0)
                ms = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    fn()
                    if device == 'cuda':
                        torch.cuda.synchronize()
                    ms.append(1e3 * (time.perf_counter() - t0))
                group = (by_model if kind == 'rows' else by_data).group()
                whole = all_gather(block, group, dim=1)[:, :h_s.shape[1]]
                name = f'{kind}_{str(dtype).split(".")[-1]}'
                if rank == 0:
                    torch.save(whole.cpu(), os.path.join(out_dir,
                                                         f'{name}.pt'))
                report[name] = {'launches': launches,
                                'ms': statistics.median(ms),
                                'collective': dispatch.decisions().get(
                                    'collective', {}).get('reason')}
    from dgmc_tpu_torch.utils.io import write_json_atomic
    write_json_atomic(os.path.join(out_dir, f'rank{rank}.json'), report)


def _par_spawn(argv_of, n, wait=True):
    """``n`` processes, rank ``r`` running ``python3 *argv_of(r)`` from the
    repository root → their ``(rc, stdout, stderr)``; with ``wait=False``
    a function that waits for them and returns that."""
    procs = [subprocess.Popen(
        [sys.executable, *argv_of(r)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(n)]
    if not wait:
        return lambda: _par_wait(procs)
    return _par_wait(procs)


def _par_wait(procs):
    runs = _finish_all(procs)
    for r, (rc, _, err, _) in enumerate(runs):
        if rc:
            raise AssertionError(f'parallel: rank {r} exited {rc}:\n'
                                 f'{err[-3000:]}')
    return [run[:3] for run in runs]


def _par_topk(tmp, device='cuda', shape=PAR_TOPK):
    """(b): the search on two ranks that share the card."""
    from dgmc_tpu_torch.ops.topk import chunked_topk
    port = _free_port()
    t0 = time.perf_counter()
    _par_spawn(lambda r: [
        '-c', f'import sys; sys.path.insert(0, "."); import chip_smoke; '
        f'chip_smoke._par_topk_rank({r}, {PAR_RANKS}, {port}, {tmp!r}, '
        f'{device!r}, {tuple(shape)!r})'], PAR_RANKS)
    wall = time.perf_counter() - t0
    ranks = []
    for r in range(PAR_RANKS):
        with open(os.path.join(tmp, f'rank{r}.json')) as f:
            ranks.append(json.load(f))
    k = shape[4]
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        h_s, h_t = _par_inputs(dtype, device, shape)
        want = chunked_topk(h_s, h_t, k).cpu()
        one_ms = (cuda_ms(lambda: chunked_topk(h_s, h_t, k), runs=5)
                  if device == 'cuda' else None)
        dt = str(dtype).split('.')[-1]
        for kind in ('rows', 'ring'):
            name = f'{kind}_{dt}'
            got = torch.load(os.path.join(tmp, f'{name}.pt'))
            if not torch.equal(got, want):
                bad = int((got != want).any(-1).sum())
                raise AssertionError(f'parallel (b): {name}: {bad} rows '
                                     f'differ from the one-process kernel')
            launches = [r[name]['launches'] for r in ranks]
            if device == 'cuda' and not all(launches):
                raise AssertionError(f'parallel (b): {name}: launches '
                                     f'{launches}')
            rows[name] = {'launches': launches,
                          'ms': [round(r[name]['ms'], 3) for r in ranks],
                          'one_process_ms': one_ms}
    log(f'parallel (b): {PAR_RANKS} ranks on one card (gloo, '
        f'{ranks[0]["rows_float32"]["collective"]}), top-k at '
        f'{"x".join(map(str, shape[1:4]))}, k = {k}, {wall:.1f}s '
        f'with start-up: indices bit-equal to the one-process kernel; '
        f'per rank launches and host ms a search beside the one-process '
        f'kernel\'s CUDA-event ms: {json.dumps(rows)}')
    return rows


def _par_lines(stdout):
    return {m.group(1): tuple(float(x) for x in m.groups()[1:])
            for m in map(EPOCH_LINE.match, stdout.splitlines()) if m}


def _par_kg(tmp, device='cuda', argv=None, ckpt=None):
    """(c): the KG CLI on two ranks sharing the card against one
    process; with ``ckpt`` the two ranks also save every epoch there (the
    ``elastic`` phase's control, :data:`ELASTIC`)."""
    return _par_kg_start(tmp, device, argv, ckpt)()


def _par_kg_start(tmp, device='cuda', argv=None, ckpt=None):
    """:func:`_par_kg`'s two ranks started → the function that waits for
    them and holds them against one process."""
    argv = list(PAR_KG_ARGV if argv is None else argv)
    saves = ['--ckpt_dir', ckpt, '--ckpt_every', '1'] if ckpt else []
    obs = os.path.join(tmp, 'obs')
    port = _free_port()
    t0 = time.perf_counter()
    # The CLI's ``main`` as ``python -m`` runs it, then the rank's launch
    # counters (from 0 at the process's start).
    runs = _par_spawn(lambda r: [
        '-c', 'import json, sys; from dgmc_tpu_torch.experiments import '
        'dbp15k; from dgmc_tpu_torch.ops.kernels import dispatch; '
        'dbp15k.main(sys.argv[1:]); print("LAUNCHES " + json.dumps('
        'dispatch.launch_counts()))', *argv, '--row_shards',
        str(PAR_RANKS), '--coordinator', f'127.0.0.1:{port}',
        '--num_processes', str(PAR_RANKS), '--process_id', str(r),
        '--obs-dir', obs, *saves], PAR_RANKS, wait=False)
    return functools.partial(_par_kg_finish, argv, obs, device, runs, t0)


def _par_kg_finish(argv, obs, device, ranks, t0):
    runs = ranks()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, one = _kg_cli(argv)
    one_s = time.perf_counter() - t0
    got, want = _par_lines(runs[0][1]), _par_lines(one)
    if not want or sorted(got) != sorted(want) or _par_lines(runs[1][1]):
        raise AssertionError(f'parallel (c): epoch lines {got} (rank 1: '
                             f'{_par_lines(runs[1][1])}) against {want}')
    for epoch, (loss, h1, h10) in want.items():
        g = got[epoch]
        if (abs(g[0] - loss) > PAR_LOSS_REL * abs(loss)
                or abs(g[1] - h1) > PAR_HITS_ABS
                or abs(g[2] - h10) > PAR_HITS_ABS):
            raise AssertionError(f'parallel (c): epoch {epoch}: {g} '
                                 f'against {(loss, h1, h10)}')
    launches = []
    for r, (_, stdout, _) in enumerate(runs):
        mine = json.loads(next(line for line in stdout.splitlines()
                               if line.startswith('LAUNCHES '))[9:])
        with open(os.path.join(obs, f'host_{r}', 'dispatch.json')) as f:
            counts = json.load(f)['counts']
        mine['collective'] = sum(c['count'] for c in counts
                                 if c['kernel'] == 'collective')
        if device == 'cuda' and not all(mine.get(k) for k in PAR_KG_KERNELS):
            raise AssertionError(f'parallel (c): rank {r} launches {mine}')
        launches.append({k: mine.get(k, 0) for k in (*PAR_KG_KERNELS,
                                                     'collective')})
    log(f'parallel (c): dbp15k --row_shards {PAR_RANKS} --num_processes '
        f'{PAR_RANKS} ({" ".join(argv)}) in {wall:.1f}s with start-up, '
        f'the one-process run in {one_s:.1f}s: epoch lines (loss, Hits@1, '
        f'Hits@10) {got} against {want}; per rank launches (the '
        f'counters) and collectives (its dispatch.json): {launches}')
    _par_account(obs)
    return launches


def _par_account(obs):
    """(c)'s collective account: each rank's ``train_step`` in
    ``host_<r>/efficiency.json`` (the cost pass of the phase-2 step),
    equal between the ranks, and ``obs.diff --min-overlap`` over it."""
    from dgmc_tpu_torch.obs import diff as diff_mod
    from dgmc_tpu_torch.utils.io import write_json_atomic
    keys = ('collectives', 'overlap_fraction', 'critical_path_share')
    acc = []
    for r in range(PAR_RANKS):
        with open(os.path.join(obs, f'host_{r}', 'efficiency.json')) as f:
            step = json.load(f)['programs']['train_step']
        acc.append({k: step.get(k) for k in keys})
    ar = [a['collectives']['ops'].get('all-reduce') if a['collectives']
          else None for a in acc]
    if None in ar or any(a != acc[0] for a in acc[1:]) or \
            acc[0]['overlap_fraction'] is None:
        raise AssertionError(f'parallel (c): the ranks\' train_step '
                             f'accounts {acc}')
    floor = acc[0]['overlap_fraction']
    host0 = os.path.join(obs, 'host_0')
    below = f'{host0}_below'
    shutil.copytree(host0, below)
    path = os.path.join(below, 'efficiency.json')
    with open(path) as f:
        eff = json.load(f)
    eff['programs']['train_step']['overlap_fraction'] = round(floor - 0.01,
                                                              4)
    write_json_atomic(path, eff)
    rcs = {}
    for name, cand in (('itself', host0), ('below the floor', below)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rcs[name] = diff_mod.main([host0, cand, '--json',
                                       '--min-overlap', str(floor)])
    if rcs != {'itself': 0, 'below the floor': 1}:
        raise AssertionError(f'parallel (c): obs.diff --min-overlap {floor}'
                             f': {rcs}')
    log(f'parallel (c): each rank\'s train_step account (the cost pass of '
        f'the phase-2 step, host_<r>/efficiency.json), equal on both: '
        f'collectives {json.dumps(acc[0]["collectives"])}, overlap_fraction '
        f'{floor}, critical_path_share {acc[0]["critical_path_share"]}; '
        f'obs.diff --min-overlap {floor}: rc {rcs["itself"]} against '
        f'itself, rc {rcs["below the floor"]} on the copy set to '
        f'{round(floor - 0.01, 4)}')


def _par_pascal(tmp, device='cuda', argv=None):
    """(d): one data-parallel ``pascal`` epoch on two ranks sharing the
    card (each its half of every batch) against one process."""
    return _par_pascal_start(tmp, device, argv)()


def _par_pascal_start(tmp, device='cuda', argv=None):
    """:func:`_par_pascal`'s two ranks started → the function that waits
    for them and holds them against one process."""
    from dgmc_tpu_torch.datasets.fixtures import write_voc
    root = os.path.join(tmp, 'voc')
    write_voc(root, seed=0, train=4, val=2)
    argv = ['--data_root', root] + list(PAR_PASCAL_ARGV if argv is None
                                        else argv)
    port = _free_port()
    t0 = time.perf_counter()
    runs = _par_spawn(lambda r: [
        '-c', 'import json, sys; from dgmc_tpu_torch.experiments import '
        'pascal; from dgmc_tpu_torch.ops.kernels import dispatch; '
        'pascal.main(sys.argv[1:]); print("LAUNCHES " + json.dumps('
        'dispatch.launch_counts()))', *argv, '--coordinator',
        f'127.0.0.1:{port}', '--num_processes', str(PAR_RANKS),
        '--process_id', str(r)], PAR_RANKS, wait=False)
    return functools.partial(_par_pascal_finish, argv, device, runs, t0)


def _par_pascal_finish(argv, device, ranks, t0):
    from dgmc_tpu_torch.experiments import pascal
    runs = ranks()
    wall = time.perf_counter() - t0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        pascal.main(argv)

    def losses(text):
        return [float(m.group(2)) for m in map(PASCAL_LOSS.match,
                                               text.splitlines()) if m]
    got, want = losses(runs[0][1]), losses(buf.getvalue())
    if (not want or len(got) != len(want) or losses(runs[1][1])
            or any(abs(g - w) > PAR_LOSS_REL * abs(w)
                   for g, w in zip(got, want))):
        raise AssertionError(f'parallel (d): losses {got} (rank 1: '
                             f'{losses(runs[1][1])}) against {want}')
    launches = []
    for _, stdout, _ in runs:
        mine = json.loads(next(line for line in stdout.splitlines()
                               if line.startswith('LAUNCHES '))[9:])
        if device == 'cuda' and not all(mine.get(k)
                                        for k in PAR_PASCAL_KERNELS):
            raise AssertionError(f'parallel (d): launches {mine}')
        launches.append({k: mine.get(k, 0) for k in PAR_PASCAL_KERNELS})
    log(f'parallel (d): pascal on {PAR_RANKS} ranks ({" ".join(argv[2:])}) '
        f'in {wall:.1f}s with start-up: epoch losses {got} against one '
        f'process\'s {want}; per rank launches {launches}')
    return launches


def _par_world1(device='cuda', backend='nccl', argv=None):
    """(a): one rank on ``backend``: the row-sharded phase-2 step,
    captured, against the unsharded captured step."""
    from dgmc_tpu_torch.experiments import dbp15k
    from dgmc_tpu_torch.ops.kernels import dispatch
    from dgmc_tpu_torch.parallel import (distributed, make_mesh,
                                         make_sharded_train_step,
                                         streamed_rules)
    from dgmc_tpu_torch.parallel.comm import backend_of
    from dgmc_tpu_torch.train.state import create_train_state
    from dgmc_tpu_torch.train.steps import batch_to_device, make_train_step
    args = dbp15k.parse_args(list(PAR_KG_ARGV if argv is None else argv)
                             + ['--stream_chunk', '8192'])
    train_b, _, in_dim = dbp15k.synthetic_batches(args)
    out = {}
    with distributed.process_group(f'127.0.0.1:{_free_port()}', 1, 0,
                                   backend=backend):
        mesh = make_mesh(data=1, device=device)
        if backend_of(mesh.group()) != backend:
            raise AssertionError(f'parallel (a): backend '
                                 f'{backend_of(mesh.group())}')
        for name in ('unsharded', 'sharded'):
            model = dbp15k.build(args, in_dim).to(device)
            state = create_train_state(model, learning_rate=args.lr)
            batch = batch_to_device(train_b, device)
            if name == 'sharded':
                step = make_sharded_train_step(
                    model, mesh, num_steps=args.num_steps, detach=True,
                    rules=streamed_rules(stream_chunk=8192))
            else:
                step = make_train_step(model, num_steps=args.num_steps,
                                       detach=True)
            built = dispatch.decisions().get('sharded_step')
            dispatch.reset()
            losses = []
            for e in range(3):
                state, m = step(state, batch,
                                dbp15k.noise_seed(0, 0, 11 + e))
                losses.append(m['loss'].clone())
            if device == 'cuda':
                torch.cuda.synchronize()
            launches = dispatch.launch_counts()
            decisions = dispatch.decisions()
            params = [p.detach().clone() for p in model.parameters()]
            seed = dbp15k.noise_seed(0, 0, 20)
            ms = (cuda_ms(lambda: step(state, batch, seed), runs=5,
                          warmup=1) if device == 'cuda' else None)
            out[name] = (torch.stack(losses), params, launches,
                         dict(decisions, sharded_step=built), ms)
            del step, state, model, batch
            gc.collect()
            if device == 'cuda':
                torch.cuda.empty_cache()
    (l0, p0, n0, _, ms0), (l1, p1, n1, d1, ms1) = (out['unsharded'],
                                                    out['sharded'])
    if not torch.equal(l0, l1) or not all(torch.equal(a, b)
                                          for a, b in zip(p0, p1)):
        worst = max(float((a - b).abs().max()) for a, b in zip(p0, p1))
        raise AssertionError(f'parallel (a): sharded losses {l1.tolist()} '
                             f'against {l0.tolist()}, parameters max '
                             f'|diff| {worst}')
    kg = {k: n1.get(k, 0) for k in PAR_KG_KERNELS}
    if n0 != n1 or (device == 'cuda' and not all(kg.values())):
        raise AssertionError(f'parallel (a): launches {n1} against {n0}')
    step_d, coll = d1.get('sharded_step'), d1.get('collective')
    if device == 'cuda' and (
            (step_d or {}).get('path') != 'captured'
            or (coll or {}).get('path') != 'device'):
        raise AssertionError(f'parallel (a): decisions {step_d} {coll}')
    log(f'parallel (a): one rank on {backend}, the row-sharded phase-2 '
        f'step captured with its all-reduces ({(coll or {}).get("counts")} '
        f'collectives over 3 steps): losses {l1.tolist()} and every '
        f'parameter bit-identical to the unsharded captured step; launches '
        f'{kg} over 3 steps, equal; a step (CUDA events, median of 5 '
        f'replays) {ms1} ms sharded, {ms0} ms unsharded')
    return kg, ms0, ms1


def phase_parallel(smi_line):
    """The multi-process paths (``dgmc_tpu_torch/parallel``): (a)
    :func:`_par_world1`, (b) :func:`_par_topk`, (c) :func:`_par_kg`, (d)
    :func:`_par_pascal`; see the module docstring. (c)'s two ranks save
    every epoch into :data:`ELASTIC`'s control directory, which the
    ``elastic`` phase resumes and removes."""
    import tempfile
    log(f'parallel: {smi_line}')
    _par_world1()
    gc.collect()
    torch.cuda.empty_cache()
    ELASTIC['control'] = tempfile.mkdtemp(prefix='elastic_control_')
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, 'topk'))
        _par_topk(os.path.join(tmp, 'topk'))
        # (c) and (d) side by side: their checks are equalities.
        kg = _par_kg_start(tmp, ckpt=ELASTIC['control'])
        dp = _par_pascal_start(tmp)
        try:
            kg()
        finally:
            dp()


#: The ``elastic`` phase: ``parallel`` (c)'s control checkpoints (the
#: two-rank run's saves of epochs 1-3, a directory :func:`phase_parallel`
#: makes and this phase removes), the schedule (epochs 4-5 at world 1,
#: the peer's death before epoch 4) and (c)'s deadline and stall.
ELASTIC = {}
ELASTIC_EPOCHS = '5'
ELASTIC_FAULT = 'peer-death@4'
FENCE_DEADLINE = 5
FENCE_STALL = 'collective-stall@2:120'


def _with_epochs(argv, epochs):
    """``argv`` (a KG CLI's flags) with ``--epochs`` at ``epochs``."""
    argv = list(argv)
    argv[argv.index('--epochs') + 1] = str(epochs)
    return argv


def _kg_proc(argv, supervise=False):
    """``python -m dgmc_tpu_torch.experiments.dbp15k argv`` started from
    the repository root, its output piped; with ``supervise``, under its
    own ``--supervise`` monitor."""
    return subprocess.Popen(
        [sys.executable, '-m', 'dgmc_tpu_torch.experiments.dbp15k',
         *(['--supervise'] if supervise else []), *argv],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _finish_all(procs, timeout=600):
    """``procs`` waited for side by side → ``[(rc, stdout, stderr, end
    time)]`` in order (the end on the host's wall clock); every process
    killed if one overruns."""
    def finish(p):
        out, err = p.communicate(timeout=timeout)
        return p.returncode, out, err, time.time()

    try:
        with concurrent.futures.ThreadPoolExecutor(len(procs)) as pool:
            return list(pool.map(finish, procs))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _two_ranks(argv, port, extra=None, supervise=False):
    """The KG CLI on two gloo ranks sharing the card (``--row_shards
    2``), rank ``r`` with ``extra[r]`` appended."""
    return [_kg_proc([*argv, '--row_shards', str(PAR_RANKS),
                      '--coordinator', f'127.0.0.1:{port}',
                      '--num_processes', str(PAR_RANKS), '--process_id',
                      str(r), *(extra or {}).get(r, [])], supervise)
            for r in range(PAR_RANKS)]


def _elastic_start(tmp, control):
    """Start (b) — one ``--supervise`` monitor per rank over one obs root,
    ``peer-death@4`` on rank 1 — and beside it (a)'s resume leg (one rank
    from ``control``, epochs 4-5 at world 1 with the flags of (b)'s
    attempt 1) and (c) (two ranks, ``collective-stall@2:120`` on rank 1
    under ``--fence-deadline 5``). → ``(processes: (b)'s two monitors,
    (a), (c)'s two ranks; (b)'s root, checkpoint dir and metrics log;
    (c)'s obs dir)``."""
    root, ck = os.path.join(tmp, 'obs'), os.path.join(tmp, 'ck')
    mlog = os.path.join(tmp, 'metrics.jsonl')
    obs_c = os.path.join(tmp, 'obs_fence')
    argv = _with_epochs(PAR_KG_ARGV, ELASTIC_EPOCHS)
    procs = _two_ranks(argv + ['--ckpt_dir', ck, '--ckpt_every', '1',
                               '--obs-dir', root, '--metrics_log', mlog],
                       _free_port(), {1: ['--inject-fault', ELASTIC_FAULT]},
                       supervise=True)
    procs.append(_kg_proc(argv + [
        '--ckpt_dir', control, '--ckpt_every', '1', '--row_shards', '1',
        '--num_processes', '1', '--obs-dir', os.path.join(tmp, 'obs_a')]))
    procs += _two_ranks(_with_epochs(PAR_KG_ARGV, 2) + [
        '--fence-deadline', str(FENCE_DEADLINE), '--obs-dir', obs_c],
        _free_port(), {1: ['--inject-fault', FENCE_STALL]})
    return procs, (root, ck, mlog), obs_c


def _elastic_restart(runs, paths):
    """(b)'s checks on its two monitors' ``runs``: rank 0 completed after
    one elastic shrink to one rank and resumed at epoch 3 with the four
    kernels launched; rank 1 retired; the report shows the shrink. →
    ``(rank 0's monitor's stdout, seconds from the tombstone to the
    resumed child's first finished step, attempt 1's launched
    kernels)``."""
    root, ck, mlog = paths
    for r, (rc, _, err, _) in enumerate(runs):
        if rc:
            raise AssertionError(f'elastic (b): rank {r}\'s monitor exited '
                                 f'{rc}:\n{err[-3000:]}')
    out0 = runs[0][1]
    lead = json.load(open(os.path.join(root, 'recovery.json')))
    follow = json.load(open(os.path.join(root, 'host_1', 'recovery.json')))
    ledger = json.load(open(os.path.join(root, 'control', 'ledger.json')))
    reason = lead['attempts'][0].get('reason', '')
    detail = [e['detail'] for e in lead['elastic']]
    if (lead['outcome'] != 'completed' or lead['restarts'] != 1
            or not reason.startswith('peer-death:host_1')
            or detail != ['--row_shards 2 -> 1 (shrink the mesh)']
            or ledger['mesh'] != {'shards': 1}):
        raise AssertionError(f'elastic (b): rank 0 outcome '
                             f'{lead["outcome"]}, restarts '
                             f'{lead["restarts"]}, reason {reason!r}, '
                             f'elastic {detail}, ledger mesh '
                             f'{ledger["mesh"]}')
    if follow['outcome'] != 'retired' \
            or follow['events'][-1]['event'] != 'retire':
        raise AssertionError(f'elastic (b): rank 1 outcome '
                             f'{follow["outcome"]}, events '
                             f'{[e["event"] for e in follow["events"]]}')
    if f'Resumed from {ck} at epoch 3.' not in out0:
        raise AssertionError(f'elastic (b): no resume at epoch 3 in\n'
                             f'{out0[-2000:]}')
    launched = _launched(os.path.join(root, 'attempt_1'), counts=True)
    if not set(PAR_KG_KERNELS) <= set(launched):
        raise AssertionError(f'elastic (b): attempt 1 launched {launched} '
                             f'as kernels, not all of {PAR_KG_KERNELS}')
    report = _module_main('dgmc_tpu_torch.obs.report', root)
    if 'elastic shrink' not in report:
        raise AssertionError(f'elastic (b): obs.report prints no elastic '
                             f'shrink:\n{report[-2000:]}')
    tomb = json.load(open(os.path.join(root, 'attempt_0', 'control',
                                       'host_1.tombstone.json')))
    first = [r for r in _read_jsonl(mlog)
             if r.get('event') == 'resume_first_step']
    if len(first) != 1:
        raise AssertionError(f'elastic (b): resume_first_step records '
                             f'{first}')
    back_s = first[0]['time'] - tomb['time']
    log(f'elastic (b): two --supervise monitors (gloo ranks sharing the '
        f'card, {" ".join(_with_epochs(PAR_KG_ARGV, ELASTIC_EPOCHS))} '
        f'--ckpt_every 1), {ELASTIC_FAULT} on rank 1: attempt 0 '
        f'{reason!r}, {detail[0]}, ledger mesh {ledger["mesh"]}, rank 1 '
        f'retired; rank 0 resumed at epoch 3 with {launched} launched as '
        f'kernels in attempt 1 (its dispatch.json); the tombstone to the '
        f'resumed child\'s first finished step {back_s:.1f}s')
    return out0, back_s, launched


def _elastic_fence(runs, obs_c):
    """(c)'s checks: rank 1 exits 67 within the deadline plus 30 s of
    entering the fence, with the fence's report; rank 0 exits 67 with
    its own report naming rank 1 (its gloo collective raised or was
    still blocked when its deadline fired); ``obs.aggregate`` lists the
    hung rank."""
    want = {'phase': 'epoch-fence', 'step': 2}
    reports = []
    for r, (rc, _, err, end) in enumerate(runs):
        path = os.path.join(obs_c, f'host_{r}', 'hang_report.json')
        if rc != 67 or not os.path.exists(path):
            raise AssertionError(f'elastic (c): rank {r} exited {rc} '
                                 f'(report {os.path.exists(path)}):\n'
                                 f'{err[-3000:]}')
        rep = json.load(open(path))
        entered = rep['time'] - rep['stalled_for_s']
        missing = [m['host'] for m in rep['missing_hosts']]
        if (rep['fence'] != want
                or not rep['reason'].startswith('fence-deadline')
                or missing != [1 - r]
                or end - entered > FENCE_DEADLINE + 30):
            raise AssertionError(f'elastic (c): rank {r}: fence '
                                 f'{rep["fence"]}, reason {rep["reason"]!r}, '
                                 f'missing {missing}, exit '
                                 f'{end - entered:.1f}s after the fence')
        reports.append((round(end - entered, 2), rep.get(
            'context', {}).get('collective_error')))
    if 'firing collective-stall@2' not in runs[1][2]:
        raise AssertionError('elastic (c): the stall did not fire')
    summary = json.loads(_module_main('dgmc_tpu_torch.obs.aggregate', obs_c,
                                      '--no-write', '--json'))
    if 'host_1' not in summary['hung_hosts']:
        raise AssertionError(f'elastic (c): aggregate lists '
                             f'{summary["hung_hosts"]}')
    return reports, summary['hung_hosts']


def elastic_launch():
    """Start the ``elastic`` phase's processes (:func:`_elastic_start`) in
    a directory of their own, their output drained by a thread; the
    ``keypoints`` phase calls this after its kernel and extractor parts,
    so that the processes run beside its CLI runs (c)-(f), and
    :func:`phase_elastic` collects them. Nothing starts without
    ``parallel`` (c)'s control checkpoint."""
    import tempfile
    control = ELASTIC.get('control')
    if not control or not os.path.isdir(os.path.join(control, '3')):
        return None
    tmp = tempfile.mkdtemp(prefix='elastic_')
    start = time.time()
    procs, paths, obs_c = _elastic_start(tmp, control)
    ELASTIC['launched'] = {
        'tmp': tmp, 'start': start, 'paths': paths, 'obs_c': obs_c,
        'runs': concurrent.futures.ThreadPoolExecutor(1).submit(
            _finish_all, procs)}
    log(f'elastic: {len(procs)} processes started')
    return ELASTIC['launched']


def phase_elastic(smi_line):
    """The supervisor's elastic restart and the fence on the card; see the
    module docstring: (b), (a)'s resume leg and (c) side by side
    (:func:`_elastic_start`; started beside the ``keypoints`` phase by
    :func:`elastic_launch`, else here), (b) checked
    (:func:`_elastic_restart`) and held bit for bit against (a), (c) by
    :func:`_elastic_fence`."""
    t_phase = time.perf_counter()
    control = ELASTIC.pop('control', None)
    launched = ELASTIC.pop('launched', None)
    beside = launched is not None
    if launched is None:
        ELASTIC['control'] = control
        launched = elastic_launch()
        ELASTIC.pop('control', None)
    try:
        if launched is None:
            raise AssertionError('elastic (a): parallel (c) left no '
                                 'checkpoint of epoch 3')
        runs = launched['runs'].result()
        took = [round(r[3] - launched['start'], 1) for r in runs]
        out_b, back_s, _ = _elastic_restart(runs[:2], launched['paths'])
        rc, out_a, err, _ = runs[2]
        if rc:
            raise AssertionError(f'elastic (a): the resume leg exited {rc}:'
                                 f'\n{err[-3000:]}')
        if f'Resumed from {control} at epoch 3.' not in out_a:
            raise AssertionError(f'elastic (a): no resume at epoch 3 in\n'
                                 f'{out_a[-2000:]}')
        lines_a, lines_b = _eval_lines(out_a), _eval_lines(out_b)
        if [x[:3] for x in lines_a] != ['004', '005'] \
                or lines_b[-2:] != lines_a:
            raise AssertionError(f'elastic: epoch lines 4-5 {lines_b} '
                                 f'against the control\'s {lines_a}')
        n = _hold_checkpoints(
            'elastic: (b)\'s final step against (a)\'s',
            torch.load(os.path.join(control, ELASTIC_EPOCHS, 'state.pt'),
                       weights_only=True),
            torch.load(os.path.join(launched['paths'][1], ELASTIC_EPOCHS,
                                    'state.pt'), weights_only=True))
        log(f'elastic (a): the control (parallel (c)\'s two ranks to epoch '
            f'3, one rank resumed to epoch {ELASTIC_EPOCHS}): (b)\'s epoch '
            f'lines 4-5 {lines_b[-2:]} equal, its step {ELASTIC_EPOCHS} '
            f'bit-identical ({n} tensors)')
        reports, hung = _elastic_fence(runs[3:], launched['obs_c'])
        log(f'elastic (c): {FENCE_STALL} on rank 1 under --fence-deadline '
            f'{FENCE_DEADLINE}: both ranks exited 67, fence {{epoch-fence, '
            f'2}}, each naming the other missing; seconds from entering '
            f'the fence to the exit and the collective\'s error by rank '
            f'{reports}; obs.aggregate hung hosts {hung}')
    finally:
        if launched is not None:
            shutil.rmtree(launched['tmp'], ignore_errors=True)
        if control:
            shutil.rmtree(control, ignore_errors=True)
    log(f'elastic: its processes, all started together'
        f'{" beside keypoints (c)-(f)" if beside else ""}, ended after '
        f'{took} s ((b)\'s monitors, (a), (c)\'s ranks): {max(took)}s; '
        f'the tombstone to the resumed step {back_s:.1f}s; this phase '
        f'{time.perf_counter() - t_phase:.1f}s on {smi_line}')


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--steps', type=int, default=0, metavar='N',
                   help='only time N dense and N KG phase-2 training steps '
                   'and profile one of each (no smoke phases)')
    p.add_argument('--kernels', action='store_true',
                   help='only time the sparse consensus forward and '
                   'route_fwd at the main path\'s shapes (no smoke phases)')
    p.add_argument('--root', default=ROOT, metavar='DIR',
                   help='the tree whose dgmc_tpu_torch is imported')
    opts = p.parse_args(argv)
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing was run', file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(opts.root))
    try:
        import dgmc_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f'chip_smoke: the dgmc_tpu_torch package is not beside this '
              f'script ({e})', file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # The precision policy's float32 accumulation of bf16 products (the
    # CLIs select it too): the bf16 yardsticks are timed under it.
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    log(f'chip_smoke: torch {torch.__version__} CUDA {torch.version.cuda} '
        f'on {torch.cuda.get_device_name(0)}; TF32 off')
    if opts.steps or opts.kernels:
        # A tree before the port's C++ collation has none to build; this
        # one builds it at first use.
        phase_build(collation=False)
        got = kernel_times() if opts.kernels else steps(opts.steps)
        log(smi[0] if smi else 'nvidia-smi: no output')
        print(json.dumps({'root': os.path.abspath(opts.root),
                          'kernels' if opts.kernels else 'steps': got}),
              flush=True)
        return 0

    t_start = time.perf_counter()
    res = {k: {} for k in ('topk', *TRAIN_KERNELS, *KG_KERNELS[1:],
                           *(f'topk@{n}' for n in SMALL_ROWS),
                           *(f'sparse_consensus_fwd@{n}' for n in SMALL_ROWS),
                           'spline_route_fwd@64', 'spline_route_bwd@64',
                           *BF16_ROWS, *RNG_ROWS, *BLOCKED_ROWS, *KP_ROWS,
                           *ROUTE_ROWS)}
    small = {n: res[f'topk@{n}'] for n in SMALL_ROWS}
    sc_small = {n: res[f'sparse_consensus_fwd@{n}'] for n in SMALL_ROWS}
    failed = []
    # The keypoints phase's host work that needs no card, done in a thread
    # while the resume phase waits on its subprocesses.
    helper = concurrent.futures.ThreadPoolExecutor(1)
    kp_prep = []

    def prepare_keypoints():
        kp_prep.append(helper.submit(_kp_prepare))
        return kp_prep[-1]

    # Each phase with the CUDA sources it waits for (None: every source).
    # The kernel phases go in the order their sources finish compiling,
    # so that they run while the slower ones still compile.
    for name, needs, fn in (
            ('build', (), lambda: phase_build(wait=False)),
            ('spline_kernel', ('spline.cu',), lambda: phase_spline_kernel(
                res['spline_route_fwd'], res['spline_route_bwd'],
                res['spline_route_fwd@64'], res['spline_route_bwd@64'],
                res['spline_records'])),
            ('consensus_kernel', ('consensus.cu',),
             lambda: phase_consensus_kernel(res['consensus_fwd'])),
            ('rng_kernel', ('rng.cu',), lambda: phase_rng_kernel(res)),
            ('blocked_kernel', ('blocked.cu',),
             lambda: phase_blocked_kernel(res)),
            ('topk_kernel', ('topk.cu',),
             lambda: phase_topk_kernel(res['topk'], small)),
            ('sparse_consensus_kernel', ('sparse_consensus.cu',),
             lambda: phase_sparse_consensus_kernel(
                 res['sparse_consensus_fwd'], res['sparse_consensus_bwd'],
                 sc_small)),
            ('bf16_kernels', None, lambda: phase_bf16_kernels(res)),
            ('serve', None, lambda: phase_serve(res['topk'], small,
                                                sc_small)),
            ('train', None, lambda: phase_train(res)),
            ('kg_train', None, lambda: phase_kg_train(res)),
            ('train_bf16', None, lambda: phase_train_bf16(res)),
            ('kg_train_bf16', None, lambda: phase_kg_train_bf16(res)),
            ('kg_tiers', None, lambda: phase_kg_tiers(res)),
            ('union_route', None, lambda: phase_union_route(res)),
            ('capture', None, phase_capture),
            ('backbones', None, phase_backbones),
            ('resume', None, lambda: phase_resume(
                smi[0] if smi else 'nvidia-smi: no output',
                beside=prepare_keypoints)),
            ('parallel', None, lambda: phase_parallel(
                smi[0] if smi else 'nvidia-smi: no output')),
            ('keypoints', None, lambda: phase_keypoints(
                res, kp_prep[0] if kp_prep else None,
                beside=elastic_launch)),
            ('elastic', None, lambda: phase_elastic(
                smi[0] if smi else 'nvidia-smi: no output')),
            ('obs', None, lambda: phase_obs(
                smi[0] if smi else 'nvidia-smi: no output')),
            ('serve_worker', None, lambda: phase_serve_worker(
                smi[0] if smi else 'nvidia-smi: no output')),
            ('lint', None, lambda: phase_lint(
                smi[0] if smi else 'nvidia-smi: no output'))):
        t0 = time.perf_counter()
        try:
            if needs != ():
                await_builds(needs)
            fn()
            log(f'phase {name}: ok in {time.perf_counter() - t0:.1f}s')
        except Exception:
            traceback.print_exc()
            failed.append(name)
            log(f'phase {name}: FAILED')
            if name == 'build':
                break
        finally:
            PHASE_END[name] = time.time()
        # A phase's captured graphs hold their memory pools until they
        # are collected (steps and engines sit in reference cycles).
        gc.collect()
        torch.cuda.empty_cache()
    helper.shutdown(wait=True)
    for key, (path, kind, shape) in RNG_ROWS.items():
        res[key]['launches'] = RNG_MAIN.get(_rng_key(path, kind, shape), 0)
        if not failed and not res[key]['launches']:
            failed.append(f'rng launches ({key})')
    log(f'rng: draw launches on the float32 main paths by (path, kind, '
        f'steps, B, P): {sorted(RNG_MAIN.items())}')
    for key, where in BLOCKED_ROWS.items():
        res[key]['launches'] = BLOCKED_MAIN.get(where, 0)
        if not failed and not res[key]['launches']:
            failed.append(f'blocked launches ({key})')
    log(f'blocked: launches on the KG main paths by (path, C, rows dtype): '
        f'{sorted(BLOCKED_MAIN.items())}')
    for key in ROUTE_ROWS:
        if not failed and not res[key].get('launches'):
            failed.append(f'routed launches ({key})')
    for key, where in KP_ROWS.items():
        res[key]['launches'] = KP_MAIN.get(where, 0)
        if not failed and not res[key]['launches']:
            failed.append(f'keypoint launches ({key})')
    log(f'keypoints: launches on the keypoint main paths by (kernel, O or '
        f'R, D, dtype): {sorted(KP_MAIN.items(), key=str)}')
    log(f'chip_smoke: all phases in {time.perf_counter() - t_start:.1f}s')
    if failed:
        print(f'chip_smoke: failed phases: {failed}', file=sys.stderr)
        return 1
    log(smi[0] if smi else 'nvidia-smi: no output')
    keys = ('name', 'route', 'source', 'replaces', 'launches',
            'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
            'library_ms', 'ms_source')
    print(json.dumps({'kernels': [{k: r[k] for k in keys}
                                  for r in res.values()]}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
