"""Observability: the run plane of the training CLIs.

The port of the JAX package's ``dgmc_tpu/obs/`` run plane (the names of
JAX's package exports, where the port has them):

- :mod:`~dgmc_tpu_torch.obs.observe` — per-step timing
  (:class:`StepTimer`), the JSONL sink (:class:`MetricLogger`) and the
  profiler context :func:`trace`.
- :mod:`~dgmc_tpu_torch.obs.registry` — counters, kernel-dispatch
  outcomes (fed by the dispatch ledger, per executed call) and compile
  events (graph captures, ``nvcc`` builds).
- :mod:`~dgmc_tpu_torch.obs.memory` — allocator and host snapshots.
- :mod:`~dgmc_tpu_torch.obs.run` — :class:`RunObserver` behind
  ``--obs-dir`` and its flags.
- :mod:`~dgmc_tpu_torch.obs.probes` — in-graph numerics probes through
  a probe tape each train step writes on the device.
- :mod:`~dgmc_tpu_torch.obs.trace` — the Chrome-trace run timeline and
  the ``--profile-dir`` / ``--profile-steps`` profiler flags.
- :mod:`~dgmc_tpu_torch.obs.watchdog`, :mod:`~dgmc_tpu_torch.obs.live`,
  :mod:`~dgmc_tpu_torch.obs.quality`, :mod:`~dgmc_tpu_torch.obs.anomaly`,
  :mod:`~dgmc_tpu_torch.obs.slo` — the watchdog, the live plane and
  flight recorder, and the quality, anomaly and SLO planes (copies of
  the JAX package's jax-free modules).
- :mod:`~dgmc_tpu_torch.obs.qtrace`, :mod:`~dgmc_tpu_torch.obs.capacity`,
  :mod:`~dgmc_tpu_torch.obs.goodput` — the serving worker's per-query
  traces, its queueing model and its padding account (copies too).
- :mod:`~dgmc_tpu_torch.obs.stages`, :mod:`~dgmc_tpu_torch.obs.cost` —
  the stage ranges and the counted FLOP and byte account per stage
  (``efficiency.json``, MFU).
- :mod:`~dgmc_tpu_torch.obs.trace_events`,
  :mod:`~dgmc_tpu_torch.obs.attribution`, :mod:`~dgmc_tpu_torch.obs.report`
  — the measured per-stage account from profiler traces and the run
  report (CLIs over files).
- :mod:`~dgmc_tpu_torch.obs.diff`, :mod:`~dgmc_tpu_torch.obs.calibrate`,
  :mod:`~dgmc_tpu_torch.obs.aggregate`, :mod:`~dgmc_tpu_torch.obs.timeline`
  — run comparison: the regression gate between two runs, its noise
  floors from repeat runs, the per-host and per-device skew, and the
  trajectory of round records (CLIs over files; copies of the JAX
  package's readers, the dispatch gate on the port's outcomes).
"""

from dgmc_tpu_torch.obs import probes
from dgmc_tpu_torch.obs.registry import (REGISTRY, CompileWatcher, Registry,
                                         compile_event_count, dispatch_table,
                                         record_dispatch)
from dgmc_tpu_torch.obs.memory import memory_snapshot
from dgmc_tpu_torch.obs.watchdog import Watchdog
from dgmc_tpu_torch.obs.run import RunObserver, add_obs_flag
from dgmc_tpu_torch.obs.trace import (ProfileHandle, add_profile_flag,
                                      export_chrome_trace, parse_step_window,
                                      profile_span, start_profile)
# Imported last: the trace() function, as in the JAX package, takes the
# package attribute the trace submodule import set just above; reach the
# submodule with `from dgmc_tpu_torch.obs.trace import ...`.
from dgmc_tpu_torch.obs.observe import MetricLogger, StepTimer, trace

__all__ = [
    'MetricLogger',
    'StepTimer',
    'trace',
    'Registry',
    'REGISTRY',
    'CompileWatcher',
    'compile_event_count',
    'record_dispatch',
    'dispatch_table',
    'memory_snapshot',
    'RunObserver',
    'add_obs_flag',
    'Watchdog',
    'probes',
    'add_profile_flag',
    'export_chrome_trace',
    'profile_span',
    'start_profile',
    'ProfileHandle',
    'parse_step_window',
]
