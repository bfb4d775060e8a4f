"""Append-only JSONL metric sink of the training CLIs (``--metrics_log``).

The port of the JAX package's ``MetricLogger`` (``dgmc_tpu/obs/
observe.py``): one object per :meth:`MetricLogger.log` call,
``{"step": ..., "time": ..., <metrics>}``, so the port's curves read like
the committed ``runs/*.jsonl``.
"""

import json
import math
import os
import time

__all__ = ['MetricLogger']


class MetricLogger:
    """Append-only JSONL metric sink (one object per ``log`` call).

    ``path=None`` disables it (every call is a no-op). ``mode='a'`` (the
    default) appends across invocations. Values with ``__float__`` (device
    scalars, numpy types) are written as floats, bools and ints keep their
    type, and a non-finite float is written as ``null`` so that the file
    stays valid JSON.
    """

    def __init__(self, path, mode='a'):
        self.path = path
        self._fh = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, mode)

    def log(self, step, **metrics):
        if self._fh is None:
            return
        rec = {'step': step, 'time': time.time()}
        for k, v in metrics.items():
            if hasattr(v, '__float__') and not isinstance(v, (bool, int)):
                v = float(v)
            if isinstance(v, float) and not math.isfinite(v):
                v = None
            rec[k] = v
        self._fh.write(json.dumps(rec) + '\n')
        self._fh.flush()

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
