"""Static analysis of the port: hazards caught before a run is launched.

The port's counterpart of the JAX package's ``dgmc_tpu/analysis`` for
four of its tiers, with the same rule ids, :class:`Finding` records,
fingerprints, baseline format and CLI contract:

- **trace tier** (:mod:`~dgmc_tpu_torch.analysis.trace_rules` over the
  specimens of :mod:`~dgmc_tpu_torch.analysis.registry`): one recorded
  run of each registered hot function (JAX's eight single-device
  specimens) on the card or the CPU, op by op, for float64 drift
  (TRC001), closed-over constants (TRC002), host reads with probes off
  (TRC003), state updated out of place (TRC004), accumulations through
  atomics (TRC005) and large sorts (TRC006);
  :mod:`~dgmc_tpu_torch.analysis.liveness` gives the same run's static
  peak-live bytes (``static_peak_bytes``, which ``python -m
  dgmc_tpu_torch.obs.cost`` writes into ``efficiency.json``).

- **source tier** (:mod:`~dgmc_tpu_torch.analysis.source_rules`):
  ``ast`` lints over *captured code* — the functions a compiled step
  (:mod:`~dgmc_tpu_torch.train.compiled`) captures into a CUDA graph,
  and ``with torch.cuda.graph(...)`` blocks — for stores that a replay
  overwrites (SRC101), host syncs (SRC102) and captures built in a loop
  (SRC103).
- **concurrency tier** (:mod:`~dgmc_tpu_torch.analysis.con_rules`, on
  the thread-entry/lock model :mod:`~dgmc_tpu_torch.analysis.
  concurrency`; copies of the JAX modules): unlocked read-modify-writes
  from threads, lock-order inversions, non-atomic artifact writes,
  unsafe signal-handler work, unbounded shared container growth.
- **recompile pass** (:mod:`~dgmc_tpu_torch.analysis.recompile`):
  signatures of padding buckets (:func:`bucket_signature`, also the
  serving router's executable key) and their churn, cross-checked
  against the capture telemetry of a recorded run's ``timings.json``.

CLI: ``python -m dgmc_tpu_torch.analysis.lint`` (``--json``,
``--select``/``--ignore``, ``--explain``, ``--fail-on new`` against the
committed ``lint-baseline-torch.json``). Importing this package imports
neither torch nor anything of the JAX package: the trace tier imports
torch when it runs. JAX's SCH, MEM and SHD tiers analyze only its mesh
specimens and wait for multi-GPU work.
"""

from dgmc_tpu_torch.analysis.findings import (Finding, Severity,
                                              load_baseline, write_baseline,
                                              split_by_baseline)
from dgmc_tpu_torch.analysis.source_rules import (lint_source_tree,
                                                  lint_source_file,
                                                  lint_source_paths)
from dgmc_tpu_torch.analysis.con_rules import (lint_concurrency_tree,
                                               lint_concurrency_file,
                                               lint_concurrency_paths)
from dgmc_tpu_torch.analysis.recompile import (analyze_buckets,
                                               bucket_signature)
from dgmc_tpu_torch.analysis.registry import (SpecimenCache,
                                              default_specimens,
                                              run_trace_tier)
from dgmc_tpu_torch.analysis.liveness import module_peak, peak_summary

__all__ = [
    'Finding',
    'Severity',
    'load_baseline',
    'write_baseline',
    'split_by_baseline',
    'lint_source_tree',
    'lint_source_file',
    'lint_source_paths',
    'lint_concurrency_tree',
    'lint_concurrency_file',
    'lint_concurrency_paths',
    'analyze_buckets',
    'bucket_signature',
    'SpecimenCache',
    'default_specimens',
    'run_trace_tier',
    'module_peak',
    'peak_summary',
]
