"""Sampled shadow audit: re-score live queries exhaustively, off-lock.

The port's copy of the JAX package's ``dgmc_tpu/serve/audit.py``. A
deterministic seeded-hash sample of live queries
(:func:`dgmc_tpu_torch.obs.quality.audit_keep`: the audited set is a
pure function of ``(seed, trace ids)``) is queued to one background
thread, re-embedded through the bucket's ψ₁ and scanned against the FULL
host-resident corpus table
(:meth:`~dgmc_tpu_torch.serve.engine.MatchEngine.exhaustive_topk`: the
offloaded search, the same top-k kernel and tie-breaking as the
in-graph shortlist). The measurement is shortlist recall@k of the
*served* candidate set against the exhaustive reference, per real query
node.

On the exact tiers the scan and the serving shortlist are the same
search, so recall must be **1.0**: the audit is a continuous
bit-exactness check, and any drop is a bug.

Off the engine's execution lock: the audit runs on its own CUDA stream
with its own host buffers and never convoys live queries.
"""

import collections
import sys
import threading

from dgmc_tpu_torch.obs.quality import audit_keep

__all__ = ['ShadowAuditor']


class ShadowAuditor:
    """One background audit thread over a bounded query queue.

    Args:
        engine: the warm :class:`~dgmc_tpu_torch.serve.engine.MatchEngine`.
        tracker: the observer's
            :class:`~dgmc_tpu_torch.obs.quality.QualityTracker` (receives
            ``observe_audit`` per audited query).
        sample_rate: keep fraction in [0, 1].
        seed: hash seed (the service's ``--seed``).
        capacity: queue bound — under backpressure new candidates are
            DROPPED and counted, never blocking the serving path.
    """

    def __init__(self, engine, tracker, sample_rate, seed=0,
                 capacity=128):
        self.engine = engine
        self.tracker = tracker
        self.sample_rate = float(sample_rate)
        self.seed = int(seed)
        self.capacity = int(capacity)
        self.dropped = 0
        self.audited = 0
        self.errors = 0
        self._queue = collections.deque()
        self._cond = threading.Condition()
        self._closed = False
        self._busy = False
        self._thread = threading.Thread(target=self._run,
                                        name='shadow-audit', daemon=True)
        self._thread.start()

    def keep(self, trace_id):
        return audit_keep(self.seed, trace_id, self.sample_rate)

    def maybe_submit(self, trace_id, graph, audit_info):
        """Enqueue one served query if the deterministic sample keeps
        it. Returns True when enqueued."""
        if not self.keep(trace_id):
            return False
        with self._cond:
            if self._closed:
                return False
            if len(self._queue) >= self.capacity:
                self.dropped += 1
                return False
            self._queue.append((trace_id, graph, audit_info))
            self._cond.notify()
        return True

    # -- the audit thread --------------------------------------------------

    def _run(self):
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if not self._queue and self._closed:
                    return
                item = self._queue.popleft()
                self._busy = True
            try:
                self._audit_one(*item)
            except Exception as e:    # noqa: BLE001 — audit never kills serving
                with self._cond:
                    self.errors += 1
                print(f'shadow-audit: {type(e).__name__}: {e}',
                      file=sys.stderr, flush=True)
            finally:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()   # wake drain() waiters

    def _audit_one(self, trace_id, graph, audit_info):
        engine = self.engine
        bucket = engine.router.route(graph.num_nodes, graph.num_edges)
        q = engine.router.pad_query(graph, bucket)
        exact = engine.exhaustive_topk(q)
        served = audit_info['shortlist_idx']    # [n_real][k] int lists
        n_real = len(served)
        k = len(served[0]) if served else 1
        reference = exact[0, :n_real]
        recalls = [
            len(set(served[i])
                & set(int(t) for t in reference[i])) / k
            for i in range(n_real)]
        recall = sum(recalls) / max(len(recalls), 1)
        # Under _cond like dropped/errors: the counters are read from
        # serving/main threads (gauges, close-time accounting) while
        # this thread increments — an unlocked += loses counts.
        with self._cond:
            self.audited += 1
        self.tracker.observe_audit(trace_id, recall,
                                   exact=recall >= 1.0)

    # -- lifecycle ---------------------------------------------------------

    def drain(self, timeout_s=60.0):
        """Block until the queue is empty and the in-flight item (if
        any) finished (deterministic accounts). Returns True when
        drained within the deadline."""
        import time
        deadline = time.time() + timeout_s
        with self._cond:
            while self._queue or self._busy:
                remaining = deadline - time.time()
                if remaining <= 0 or not self._cond.wait(
                        timeout=remaining):
                    return False
            return True

    def close(self, timeout_s=10.0):
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._thread.join(timeout=timeout_s)
