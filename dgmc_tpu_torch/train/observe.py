"""Deprecated alias of :mod:`dgmc_tpu_torch.obs.observe`
(``dgmc_tpu/train/observe.py``): experiment code importing
``dgmc_tpu_torch.train.{trace, StepTimer, MetricLogger}`` keeps working;
new code imports them from :mod:`dgmc_tpu_torch.obs`."""

from dgmc_tpu_torch.obs.observe import (MetricLogger, StepTimer,  # noqa: F401
                                        trace)

__all__ = ['MetricLogger', 'StepTimer', 'trace']
