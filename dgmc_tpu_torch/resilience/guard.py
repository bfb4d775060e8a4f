"""Host-side rollback policy over the in-graph non-finite guard.

The port's copy of ``dgmc_tpu/resilience/guard.py``.
``make_train_step(guard=True)`` skips the update of any step whose loss
or gradient norm is not finite and counts the skips in the
:class:`~dgmc_tpu_torch.train.state.GuardedTrainState`, on the device,
with no host read. Restoring the last good parameters is a host
decision: :class:`RollbackGuard` makes it where the training loop
already reads its metrics (the CLI's eval boundaries), so it adds no
device round trip of its own. A rollback is logged to the run's
``--metrics_log`` and, with an observer, to its ``metrics.jsonl`` as
``event='rollback'``, and dumps the observer's flight recorder
(``flight.json``, reason ``guard-rollback``).
"""

import sys

from dgmc_tpu_torch.train.state import restore_params, snapshot_params

__all__ = ['RollbackGuard']


class RollbackGuard:
    """Snapshot on good, roll back after M consecutive bad steps.

    Args:
        max_consecutive: M: a rollback when the in-graph ``consec_bad``
            counter reaches M (0 disables).
        logger: optional :class:`~dgmc_tpu_torch.obs.observe.MetricLogger`
            that records each rollback.
        obs: optional :class:`~dgmc_tpu_torch.obs.run.RunObserver`: each
            rollback is logged to it and dumps its flight recorder (the
            probe values and spans that led into the non-finite streak).
    """

    def __init__(self, max_consecutive, logger=None, obs=None):
        self.max_consecutive = int(max_consecutive)
        self.logger = logger
        self.obs = obs
        self.rollbacks = 0
        self._snapshot = None
        self._snapshot_step = None

    def note_good(self, state, model, step=None):
        """Record ``model``'s parameters and buffers as the newest known
        good rollback target. Call once the host has seen finite metrics
        for them."""
        self._snapshot = snapshot_params(model)
        self._snapshot_step = step

    def maybe_rollback(self, state, model, consec_bad, step=None):
        """``(state, rolled_back)``: restores the last good snapshot in
        place, with a fresh optimizer (the willow reset), when
        ``consec_bad >= M``. ``state.step`` and the cumulative
        ``skip_count`` survive; ``consec_bad`` goes back to 0. Without a
        snapshot yet (the run went bad before its first good read) the
        guarded step keeps the parameters frozen, which is safe; it says
        so."""
        if not self.max_consecutive \
                or int(consec_bad) < self.max_consecutive:
            return state, False
        if self._snapshot is None:
            print('[guard] rollback wanted but no good snapshot exists '
                  'yet; params stay frozen by the in-graph guard',
                  file=sys.stderr, flush=True)
            return state, False
        step_count = state.step
        restore_params(state, model, self._snapshot)
        state.step = step_count
        if getattr(state, 'consec_bad', None) is not None:
            state.consec_bad.zero_()
        self.rollbacks += 1
        print(f'[guard] {int(consec_bad)} consecutive non-finite steps: '
              f'rolled back to the step-{self._snapshot_step} snapshot '
              f'(fresh optimizer)', file=sys.stderr, flush=True)
        record = {'rollback_to': self._snapshot_step,
                  'consec_bad': int(consec_bad), 'rollbacks': self.rollbacks}
        if self.logger is not None:
            self.logger.log(step if step is not None else -1,
                            event='rollback', **record)
        if self.obs is not None:
            self.obs.log(step if step is not None else -1, event='rollback',
                         **record)
            self.obs.flight_dump('guard-rollback', extra=record)
        return state, True
