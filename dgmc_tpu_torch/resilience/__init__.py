"""Resilience: deterministic fault injection and the rollback guard over
the train step's in-graph non-finite guard."""

from dgmc_tpu_torch.resilience.faults import (FaultInjected, FaultPlan,
                                              add_fault_args,
                                              corrupt_checkpoint, parse_spec)
from dgmc_tpu_torch.resilience.guard import RollbackGuard

__all__ = ['FaultInjected', 'FaultPlan', 'RollbackGuard', 'add_fault_args',
           'corrupt_checkpoint', 'parse_spec']
