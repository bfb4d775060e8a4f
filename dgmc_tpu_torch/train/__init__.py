"""Training: the train state (Adam), the train / eval steps and
checkpoints (the JAX package's ``dgmc_tpu.train`` names)."""

from dgmc_tpu_torch.train.state import (TrainState, GuardedTrainState,
                                        create_train_state, init_variables,
                                        with_guard_counters, snapshot_params,
                                        restore_params)
from dgmc_tpu_torch.train.steps import (make_train_step, make_eval_step,
                                        aggregate_eval)
from dgmc_tpu_torch.train.checkpoint import (Checkpointer, CheckpointError,
                                             CheckpointCorruptError,
                                             resume_or_init)
# Deprecated aliases, as in the JAX package: the observability layer
# lives in dgmc_tpu_torch.obs.
from dgmc_tpu_torch.obs.observe import MetricLogger, StepTimer, trace

__all__ = ['TrainState', 'GuardedTrainState', 'create_train_state',
           'init_variables', 'with_guard_counters', 'make_train_step',
           'make_eval_step', 'aggregate_eval', 'Checkpointer',
           'CheckpointError', 'CheckpointCorruptError', 'resume_or_init',
           'snapshot_params', 'restore_params', 'MetricLogger', 'StepTimer',
           'trace']
