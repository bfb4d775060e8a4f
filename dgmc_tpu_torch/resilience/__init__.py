"""Resilience: deterministic fault injection, the rollback guard over
the train step's in-graph non-finite guard, and the run supervisor
(:mod:`~dgmc_tpu_torch.resilience.supervisor`)."""

from dgmc_tpu_torch.resilience.faults import (FaultInjected, FaultPlan,
                                              FaultSpec, add_fault_args,
                                              corrupt_checkpoint, ledger_dir,
                                              parse_spec)
from dgmc_tpu_torch.resilience.guard import RollbackGuard
from dgmc_tpu_torch.resilience.supervisor import (Supervisor,
                                                  add_supervisor_args,
                                                  strip_supervisor_args,
                                                  supervise_cli)

__all__ = ['FaultInjected', 'FaultPlan', 'FaultSpec', 'RollbackGuard',
           'Supervisor', 'add_fault_args', 'add_supervisor_args',
           'corrupt_checkpoint', 'ledger_dir', 'parse_spec',
           'strip_supervisor_args', 'supervise_cli']
