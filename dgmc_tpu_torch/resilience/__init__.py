"""Resilience: deterministic fault injection, the rollback guard over
the train step's in-graph non-finite guard, the run supervisor
(:mod:`~dgmc_tpu_torch.resilience.supervisor`) and the distributed
control plane (:mod:`~dgmc_tpu_torch.resilience.distributed_guard`:
per-rank heartbeats, tombstones, the rank-0 recovery ledger and fences
with deadlines, which the supervisor turns into elastic restarts)."""

from dgmc_tpu_torch.resilience.distributed_guard import (FENCE_TIMEOUT_RC,
                                                         FenceGuard,
                                                         HostChannel,
                                                         RecoveryLedger)
from dgmc_tpu_torch.resilience.faults import (FaultInjected, FaultPlan,
                                              FaultSpec, add_fault_args,
                                              corrupt_checkpoint, ledger_dir,
                                              parse_spec)
from dgmc_tpu_torch.resilience.guard import RollbackGuard
from dgmc_tpu_torch.resilience.supervisor import (Supervisor,
                                                  add_supervisor_args,
                                                  strip_supervisor_args,
                                                  supervise_cli)

__all__ = ['FENCE_TIMEOUT_RC', 'FaultInjected', 'FaultPlan', 'FaultSpec',
           'FenceGuard', 'HostChannel', 'RecoveryLedger', 'RollbackGuard',
           'Supervisor', 'add_fault_args', 'add_supervisor_args',
           'corrupt_checkpoint', 'ledger_dir', 'parse_spec',
           'strip_supervisor_args', 'supervise_cli']
