"""The rule catalog: every lint rule's id, tier, severity, and doc.

The port's counterpart of the JAX package's ``dgmc_tpu/analysis/
catalog.py`` for JAX's six tiers: trace (TRC, over one recorded run of
each specimen), sharded (SHD) and schedule & liveness (SCH/MEM, over the
mesh specimens' runs on ranks), source (SRC, rewritten for captured
code), recompile (RCP) and concurrency (CON, copied). One
structured table owns what a rule IS (``--list-rules``) and what it
means (``--explain RULE`` — what/why/fix). Pure data, so the CLI can
answer ``--explain`` without importing torch's backends.
"""

import dataclasses
from typing import Dict

__all__ = ['RuleDoc', 'RULES', 'RULE_CATALOG', 'TIERS', 'explain_rule']

#: Tier key -> human name (the order tiers report in).
TIERS = {
    'TRC': 'trace (one recorded run of each registered specimen)',
    'SRC': 'source (ast lints over the package source)',
    'RCP': 'recompile (padding-bucket churn + obs telemetry)',
    'SHD': 'sharded (the collectives of the mesh specimens\' runs)',
    'SCH': 'schedule (list-schedule overlap over the mesh specimens\' '
           'runs)',
    'MEM': 'liveness (static peak-live bytes over the mesh specimens\' '
           'runs)',
    'CON': 'concurrency (thread-entry/lock model over serving source)',
}


@dataclasses.dataclass(frozen=True)
class RuleDoc:
    """One rule's documentation: a one-line title plus what/why/fix."""
    rule: str
    severity: str
    title: str
    what: str
    why: str
    fix: str

    @property
    def tier(self) -> str:
        return TIERS[self.rule[:3]]


def _r(rule, severity, title, what, why, fix):
    return RuleDoc(rule=rule, severity=severity, title=title, what=what,
                   why=why, fix=fix)


RULES: Dict[str, RuleDoc] = {d.rule: d for d in [
    # --- trace tier ------------------------------------------------------
    _r('TRC001', 'error',
       'dtype promotion: 64-bit float introduced in a <=32-bit pipeline',
       'An op of a specimen\'s recorded run introduces a float64 or '
       'complex128 result from inputs none of which is one. int64 is '
       'torch\'s index dtype (gather, sort, argsort and nonzero take or '
       'return it), so it is not drift and is not flagged.',
       'The pipeline is float32-or-narrower by design: the H100 runs '
       'float64 at a fraction of its float32 rate and the tensor cores '
       'not at all, and one wide value widens everything downstream. '
       'The CPU plain draws compute Box-Muller in float64 on purpose '
       '(ops/kernels/rng.py, the one-ulp contract with the CUDA draw '
       'kernel): those sites are reviewed and baselined, not exempted.',
       'Find the introducing op (the finding carries its source line) '
       'and pin its dtype: usually a .double(), a float64 numpy array '
       'made a tensor, or torch.tensor of a Python float with a float64 '
       'default dtype.'),
    _r('TRC002', 'warning',
       'giant constant closed over by the program',
       'The recorded run reads a tensor above --max-const-bytes '
       '(default 1 MiB) that is no argument, parameter, buffer or '
       'optimizer state and was not made in the run.',
       'A captured step bakes such a tensor\'s address into every '
       'replay: it cannot be swapped, sharded or freed, and it usually '
       'means a dataset or lookup table was closed over instead of '
       'being passed in.',
       'Pass the tensor as an argument (or register it as a buffer) '
       'instead of closing over it.'),
    _r('TRC003', 'error',
       'host read in a program expected free of them (probes off)',
       'With probes off, the recorded run reads the device from the '
       'host: .item() / float() / bool() (_local_scalar_dense, '
       'is_nonzero), torch.equal, an op whose output size depends on '
       'the data (nonzero, masked_select, unique, boolean indexing, '
       'repeat_interleave without output_size), or a copy from the card '
       'to the host. The dynamic counterpart of SRC102. A CPU Adam\'s '
       'read of its own host step count (torch refuses capturable for '
       'CPU tensors) is the optimizer\'s, not the program\'s.',
       'A host read synchronizes the host with the card every step, '
       'and a captured step cannot contain one: the capture raises.',
       'Keep the value on the device (torch.where, clamp, a mask) or '
       'read it once outside the step; gate a diagnostic behind the '
       'probe switch (obs/probes.py).'),
    _r('TRC004', 'error',
       'state declared in place was rebound or written out of place',
       'After one run of the step as the CLIs run it (captured on the '
       'card, jit=True), a tensor of the state it declares it updates '
       'in place (parameters, buffers, Adam\'s moments and step counts, '
       'the guard\'s counters) is not the tensor or the storage it was '
       'before. The counterpart of JAX\'s dropped donation.',
       'A captured replay writes the storages it recorded: a rebound '
       'parameter (p.data = ..., a new nn.Parameter, a new Adam moment '
       'tensor) leaves the replay updating a storage nobody reads, and '
       'the model stops training without an error.',
       'Update in place (copy_, add_, the optimizer\'s foreach ops; '
       'train/state.py\'s write_state for restores).'),
    _r('TRC005', 'info',
       'floating-point accumulation through atomics',
       'The recorded run accumulates floats with scatter_add, '
       'scatter_reduce, index_add, index_put(accumulate=True) or an '
       'embedding backward — a gather\'s or an index\'s backward among '
       'them.',
       'On the card these add with atomics in no fixed order, so the '
       'sums are not bit-identical from run to run — the port promises '
       'bit-identical repeats for its forward aggregations '
       '(ops/graph.py). The reviewed backward sites are baselined; the '
       'rule catches new ones.',
       'Prefer the sorted or blocked sums (ops/graph.py segment_sum, '
       'ops/blocked.py) on hot paths; where the accumulation is '
       'inherent, review and baseline it.'),
    _r('TRC006', 'warning',
       'large sort where a top-k selection was intended',
       'A sort / argsort / topk over an axis of >= 4096 elements.',
       'A full sort of a large axis is a multi-pass bandwidth-bound '
       'operation; every such site in this codebase was meant to be '
       'the top-k kernel or the streaming blockwise top-k.',
       'Use ops/topk.py (chunked_topk / streamed_topk, the CUDA top-k '
       'kernel on the card) instead of sort / argsort / topk.'),
    # --- source tier -----------------------------------------------------
    _r('SRC100', 'error', 'source file failed to parse',
       'The source tier could not ast-parse a .py file.',
       'An unparseable file is invisible to every source rule — the '
       'lint would silently stop covering it.',
       'Fix the syntax error (the finding carries the location).'),
    _r('SRC101', 'error',
       'captured function stores to self/global',
       'Captured code (the def passed to compiled(...) / Compiled(...), '
       'or the body of a `with torch.cuda.graph(...)` block) assigns '
       'self.<attr> or a declared module global.',
       'The capture runs the Python once; replays run only the graph. '
       'A stored tensor is a static buffer that the next replay '
       'overwrites in place, and any other stored value is set at '
       'capture and never updated again.',
       'Return the value from the step (and clone it to keep it past '
       'the next call), or move the store outside the captured '
       'function.'),
    _r('SRC102', 'warning',
       'host sync inside captured code (.item/.cpu/float/np.asarray/'
       'synchronize)',
       'x.item() / x.tolist() / x.cpu() / x.numpy(), float(x) / int(x) / '
       'bool(x) on a non-constant, np.asarray(x) / np.array(x), or a '
       '.synchronize() inside captured code.',
       'Each reads the device from the host. A capture runs under '
       "set_sync_debug_mode('error') and raises on it, but only on the "
       'branch its warm-up reaches: a sync on another branch waits '
       'for the data that selects it.',
       'Keep the value on the device (torch ops, torch.where for '
       'control flow); read it on the host after the step returns.'),
    _r('SRC103', 'warning',
       'compiled(...) / CUDAGraph constructed inside a loop',
       'compiled(...), Compiled(...) or torch.cuda.CUDAGraph() is '
       'called inside a loop body.',
       'Every iteration builds a fresh wrapper and throws away the '
       "records the last one captured (graphs, static buffers, their "
       'private memory pools): a capture per iteration, the recompile '
       'churn of the port.',
       'Build the compiled step once, outside the loop, and call it in '
       'the loop.'),
    _r('SRC104', 'warning',
       'static arg with an unhashable (mutable) default',
       'Kept for the rule id only: it cannot fire on the port. The JAX '
       "package's rule flags static_argnums/static_argnames naming a "
       'parameter with a mutable default; compiled(...) takes no static '
       'argument.',
       'A compiled step keys its records on a signature it builds from '
       'its inputs: a tensor or graph batch by shapes and dtypes, a '
       'Python int as the word int (its value becomes a 0-d device '
       'tensor), a Fixed input by identity, None as absent; any other '
       'input raises TypeError at the call. No input value is a cache '
       'key, so no default can explode as one.',
       'Nothing to fix; the id stays so that a baseline or --select '
       'naming it keeps its meaning in both packages.'),
    # --- recompile pass --------------------------------------------------
    _r('RCP201', 'warning',
       'padding bucket dominated by another (avoidable compile churn)',
       'A padding bucket every one of whose padded dimensions is <= '
       'another bucket of the SAME pair-batch size.',
       'Collating into the bigger padding serves both batches with ONE '
       'captured graph at the cost of a few masked rows; the dominated '
       'bucket is pure capture churn. The pair-batch axis (B, '
       '--pairs-per-step) is deliberately NOT a padding axis: padding '
       'B replicates the whole per-pair cost and changes how many '
       'gradient samples a step averages.',
       'Collate into the larger node/edge padding (utils/data.'
       'pad_pair_batch limits) so the dominated bucket disappears.'),
    _r('RCP202', 'warning',
       'compile events exceed what padding buckets explain',
       'An obs-recorded run captured more graphs than its distinct '
       'padding signatures * the per-bucket budget. The count is the '
       "captures (timings.json's compile.by_kind.capture): a kernel "
       "source's nvcc build is not a program of a bucket.",
       'Recaptures are coming from somewhere the padding analysis '
       'cannot see: an input whose identity changes per call (a Fixed '
       'input rebuilt each step), a dtype flip, an optional input that '
       'comes and goes.',
       'Diff the compile-event labels in the obs run (timings.json) '
       'against the padding buckets; stabilize whatever input is '
       'changing identity.'),
    # --- sharded tier ----------------------------------------------------
    _r('SHD301', 'error',
       'collective sequence diverges across ranks',
       'A mesh specimen\'s run is one path on each rank, so the rule '
       'compares the ranks\' collective sequences (kind, group, dtype, '
       'shape, in order) with rank 0\'s; the first position where a rank '
       'differs is the finding, at that collective\'s line. The runtime '
       'face of JAX\'s branch-divergent conditional.',
       'A rank that posts a collective its peers never enter (or a '
       'different one) blocks forever: the multichip-hang class. Every '
       'collective of the port goes through parallel/comm.py on every '
       'rank of its group; a data-dependent branch around one breaks '
       'that.',
       'Issue the same collectives in the same order on every rank, '
       'whatever its data: hoist the collective out of the branch, or '
       'make both sides communicate identically.'),
    _r('SHD302', 'error',
       'full replication of a correspondence-shaped tensor',
       'An all-gather or broadcast (parallel/comm.py) whose result has '
       'rank >= 3 and at least the specimen\'s declared correspondence '
       'payload (corr_bytes: the [B, N_s, N_t] S).',
       'The row layout exists to keep S in row blocks; one all-gather '
       'of it puts the whole matrix on every card — at the '
       'million-entity scale of ROADMAP item 3 an out-of-memory.',
       'Keep S in its row blocks: reduce shard-locally (the row sums the '
       'consensus step all-reduces are [B, N_t, R], not S) and gather '
       'only the [B, N_s, k] candidates, as parallel/topk.py does.'),
    _r('SHD303', 'warning',
       'resharding churn inside one step',
       'Two or more resharding collectives in one step where one\'s '
       'input derives from the other\'s output: an all-to-all, or a '
       'send / recv (JAX\'s collective-permute) fed by another. None is '
       'issued today: parallel/comm.py has no all-to-all and no send / '
       'recv, and the port\'s target ring moves no data (each rank holds '
       'every shard, parallel/topk.py). The rule holds on crafted tapes.',
       'The layout is bounced every step: communication that scales '
       'with the steps instead of being paid once.',
       'Settle the layout once (the rules of parallel/rules.py) instead '
       'of round-tripping it inside the step.'),
    _r('SHD304', 'warning',
       'per-step collective payload exceeds the specimen budget',
       'The run\'s total collective payload (the bytes JAX counts: the '
       'gathered result of an all-gather) exceeds the specimen\'s '
       'comm_budget_bytes (analysis/registry.py, measured on the CPU '
       'ranks with 8x headroom; --comm-budget-bytes for a specimen '
       'without one).',
       'Silent growth in moved bytes is how sharding regressions land '
       'unnoticed.',
       'If the new communication is intended, raise the budget in the '
       'registry and re-baseline; otherwise find the collective the '
       'breakdown names.'),
    _r('SHD305', 'error',
       'precision contract: a bf16 accumulator',
       'An accumulation into a bf16 result: an all-reduce of a bf16 '
       'tensor (NCCL sums in bf16) or a scatter / index_add accumulation '
       'in bf16, with at least 64 addends; worst when an explicit '
       'float32 -> bf16 _to_copy feeds it. Torch\'s matmuls and '
       'reductions accumulate in float32 internally (the precision '
       'policy switches cuBLAS\'s bf16 reduction off), so they are no '
       'finding.',
       'models/precision.py\'s contract is bf16 compute with float32 '
       'accumulation: a bf16 running sum stops absorbing addends once it '
       'is ~256x any of them.',
       'Sum in float32 and cast after: all-reduce a float32 copy (as '
       'StepComm.grads sums its float32 flat buffer), accumulate the '
       'scatter into a float32 tensor.'),
    # --- schedule & liveness tier ----------------------------------------
    _r('SCH401', 'error',
       'async collective serialized inside a loop',
       'An asynchronous collective, in a loop (recurring at one line), '
       'whose wait follows it with no compute in between in program '
       'order. None is issued today: the port\'s collectives are '
       'synchronous calls, so the rule holds on crafted tapes.',
       'The program paid for asynchrony and then blocked on it '
       'immediately: the loop runs in lockstep.',
       'Issue the compute that does not need the result between the '
       'collective and its wait, or double-buffer the loop.'),
    _r('SCH402', 'warning',
       'modeled collective overlap below the specimen budget',
       'The run\'s collective overlap fraction in the schedule model '
       '(analysis/schedule.py: JAX\'s two-stream list schedule over the '
       'tape\'s dependencies, byte proxies for durations) fell below the '
       'specimen\'s overlap_budget (the CPU ranks\' value x 0.77, JAX\'s '
       'headroom).',
       'The model measures the dependency slack, not wall time: a drop '
       'means an edit added a dependency that forces serialization.',
       'If intended, lower the overlap_budget in the registry and '
       're-baseline; otherwise find the new dependency of the '
       'collectives (the finding counts the serialized ones).'),
    _r('SCH403', 'info',
       'per-iteration fetch serialized on the critical path '
       '(double-buffer opportunity)',
       'A fetch (a gather, index_select, an indexing gather, a '
       'collective or a host -> device copy) on the run\'s critical path '
       'that feeds compute, recurs at one line (a loop\'s iterations) '
       'and moves at least double_buffer_min_bytes.',
       'Iteration k+1\'s fetch cannot start until iteration k is done: '
       'the serial chunk loop ROADMAP item 4 wants pipelined. INFO: an '
       'opportunity, not a defect.',
       'Fetch chunk k+1 while computing chunk k (a prefetch ring, as '
       'ops/offload.py does on a copy stream).'),
    _r('MEM404', 'error',
       'static peak-live bytes exceed the specimen budget',
       'The liveness bound of the run (analysis/liveness.py: each '
       'storage from its op to its last use, the arguments live '
       'throughout) exceeds the specimen\'s peak_bytes_budget (the CPU '
       'ranks\' peak x 1.5).',
       'Memory regressions must fail the lint before a scale run, not '
       'during one.',
       'If the growth is intended, raise peak_bytes_budget and '
       're-baseline; otherwise the finding names the stages holding '
       'bytes at the peak — find the buffer that began outliving its '
       'consumer.'),
    _r('MEM405', 'error',
       'residual scales with the full streamed axis',
       'A storage of rank >= 2 and at least residual_min_bytes, made in '
       'the forward and read in the backward (an autograd residual) or '
       'carried from one iteration of a loop to the next, whose shape '
       'holds the full streamed axis (stream_full) rather than the chunk '
       '(or stacks one slab per chunk over the whole axis).',
       'JAX\'s PR 9 class: a chunked search that keeps per-chunk masks '
       'for the backward holds the whole corpus axis — gigabytes for a '
       'search whose state is [rows, k].',
       'Keep the search out of autograd (the port\'s top-k runs under '
       'no_grad) or recompute in the backward.'),
    # --- concurrency tier ------------------------------------------------
    _r('CON501', 'error',
       'shared attribute read-modify-written from a thread with no lock',
       'A class attribute is read-modify-written (`+=` / `self.x = '
       'self.x + ...`) from a method reachable from a thread entry '
       'point (Thread/Timer target, do_GET/do_POST handler, '
       'signal/atexit hook) while no write site of that attribute in '
       'the class holds a lock. Plain rebinding is exempt: a single '
       'STORE_ATTR is atomic under the GIL.',
       'Python `+=` on an attribute is read-op-write, not atomic: '
       'concurrent handler threads interleave between the read and the '
       'store and increments vanish silently — the serve-counter race '
       '(queries_served undercounted under load) as a rule class.',
       'Guard every write of the attribute with the class lock '
       '(`with self._lock: self.n += 1` — StreamingHistogram.observe '
       'in obs/live.py is the in-repo model), or make the state '
       'thread-local and merge on read.'),
    _r('CON502', 'error',
       'nested lock acquisition order inconsistent across call paths',
       'Two locks of one class are acquired nested in both orders — '
       'A then B on one path, B then A on another — lexically or one '
       '`self.<m>()` call level deep.',
       'Opposite acquisition orders deadlock by construction: the '
       'first time two threads interleave between the outer and inner '
       'acquire, each holds what the other needs, forever. The serve '
       'engine already carries two locks and the continuous batcher '
       'adds a queue lock — order discipline has to be mechanical.',
       'Pick one canonical order for every pair of locks and '
       'restructure the second path to match (or release the first '
       'lock before taking the second, as engine.match does between '
       'its admission and stats sections).'),
    _r('CON503', 'warning',
       'consumed artifact written in place (no tmp+rename)',
       "open(path, 'w') on an artifact path in a function that never "
       'calls os.replace/os.rename and whose path expression does not '
       'name a temp file.',
       'The write is torn twice over: a concurrent reader (supervisor, '
       'scraper, restarted worker) can open the file mid-write, and a '
       'crash leaves a truncated artifact that poisons the next run. '
       'Every obs artifact writer in this repo uses tmp+os.replace for '
       'exactly this reason.',
       'Write through utils/io.write_json_atomic, or an explicit '
       "f'{path}.tmp.{pid}' + os.replace; append mode is exempt."),
    _r('CON504', 'error',
       'unsafe work inside a signal handler',
       'A registered signal.signal handler acquires a lock, performs '
       'buffered IO (open/print/logging), or builds allocation-heavy '
       'formatted output (json.dumps, str.format, traceback.format_*) '
       'directly in its body.',
       'The handler runs with the interrupted thread stopped at an '
       'arbitrary bytecode: any lock it takes may already be held '
       '(instant deadlock), and buffered IO can re-enter stream '
       'internals mid-update. The watchdog signal path is lock-free '
       'by contract for exactly this reason.',
       'Set a flag/Event and do the work on a thread, or restrict the '
       'handler to pre-cached state and lock-free writes (the '
       'watchdog `_on_signal` -> `dump(use_locks=False)` model).'),
    _r('CON505', 'warning',
       'shared container grows without bound from a serving thread',
       'A list/dict/set/deque attribute built in __init__ grows '
       '(.append/.add/keyed store) from a thread-entry method while '
       'the class shows no cap: no deque(maxlen=...), no len() check, '
       'no eviction or rotation.',
       'A long-lived serving process accretes per-query state forever '
       'until the OOM killer arrives — hours or days after the deploy, '
       'far from the cause. The bounded-ring discipline (FlightRecorder '
       'deque(maxlen), qtrace capacity with drop accounting) exists '
       'for this.',
       'Use collections.deque(maxlen=...) for rings, or an explicit '
       'capacity check with drop/evict accounting on every growth '
       'path.'),
]}

#: ``{rule: one-line title}`` — the ``--list-rules`` table (lint.py
#: re-exports it).
RULE_CATALOG = {rule: doc.title for rule, doc in RULES.items()}


def explain_rule(rule: str) -> str:
    """The ``--explain`` rendering of one rule (raises KeyError on an
    unknown id)."""
    d = RULES[rule]
    return (f'{d.rule} — {d.title}\n'
            f'  severity: {d.severity}    tier: {d.tier}\n'
            f'  What: {d.what}\n'
            f'  Why:  {d.why}\n'
            f'  Fix:  {d.fix}')
