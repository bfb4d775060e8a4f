"""The registry's mesh specimens on ranks: each run once per rank, its
tape and account sent back as plain data.

JAX compiles its mesh specimens (``min_devices`` 2 or 4) under a mesh of
the process's devices. A port process drives one card, so a mesh is a
group of processes: where the calling process is not in a world of
enough ranks, the consumers (the lint CLI, ``obs.cost``'s specimen rows
and the schedule CLI) start :data:`DEFAULT_RANKS` local ranks on gloo
(:func:`start`, at once or beside other work), each of which builds and runs every mesh specimen once
(:func:`record_mesh`: the one recorded run of
:class:`~dgmc_tpu_torch.analysis.registry.SpecimenArtifacts`, the trace
tier's in-place check where the specimen declares it) and pickles its
records; the parent analyzes them. On ``cuda`` the ranks share the card
(``cuda:<rank % device count>``; gloo stages the collectives through the
host: NCCL refuses two ranks on one device). A process already in a
world of at least 4 ranks runs its own part in place and gathers the
others' records (:func:`gather_in_world`).

A specimen smaller than the world runs on the first ranks; the others
create its mesh's process groups (every rank must) and record nothing
(``None``). Each record: ``{'tape', 'cost', 'launches', 'seconds',
'measured_peak_bytes', 'output', 'inplace', 'budgets', 'stats',
'rank', 'device'}``, ``output`` the result as NumPy (a train step's
metrics and, under ``'params'``, the model's state after the step).
"""

import contextlib
import dataclasses
import importlib
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time

__all__ = ['DEFAULT_RANKS', 'mesh_specimens', 'record_specimen',
           'record_mesh', 'by_specimen', 'gather_in_world', 'RankRun',
           'start', 'MeshRuns']

#: The ranks a consumer starts: JAX's largest mesh specimen takes 4.
DEFAULT_RANKS = 4

#: The keys of a mesh specimen's build that carry its thresholds and
#: budgets (JAX's names).
BUDGET_KEYS = ('corr_bytes', 'comm_budget_bytes', 'overlap_budget',
               'peak_bytes_budget', 'stream_full', 'stream_chunk',
               'residual_min_bytes', 'double_buffer_min_bytes')

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def mesh_specimens(names=None):
    """The registered specimens that need more than one rank, in registry
    order (``names`` restricts them)."""
    from dgmc_tpu_torch.analysis.registry import default_specimens
    return [s for s in default_specimens() if s.min_devices
            and (names is None or s.name in names)]


def _plain(x):
    """``x`` with its tensors as NumPy (train states dropped, dataclasses
    as dicts of their fields)."""
    import torch
    from dgmc_tpu_torch.train.state import TrainState
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if isinstance(x, TrainState):
        return None
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    return x


def record_specimen(spec, device, inject=None):
    """One specimen's record on this rank (``None`` outside its mesh;
    see the module docstring)."""
    import torch
    from dgmc_tpu_torch.analysis.registry import SpecimenArtifacts
    from dgmc_tpu_torch.parallel.distributed import process_index
    art = SpecimenArtifacts(spec, device, inject=inject)
    built = art.built()
    if built is None:
        return None
    rec = art.recorded()
    output = {'result': _plain(rec['output'])}
    for obj in built.get('keep') or ():
        if isinstance(obj, torch.nn.Module):
            output['params'] = {k: v.detach().cpu().numpy().copy()
                                for k, v in obj.state_dict().items()}
    inplace = art.inplace()
    return {'tape': rec['tape'], 'cost': rec['cost'],
            'launches': rec['launches'], 'seconds': rec['seconds'],
            'measured_peak_bytes': rec['measured_peak_bytes'],
            'output': output, 'inplace': inplace,
            'budgets': {k: built[k] for k in BUDGET_KEYS if k in built},
            'stats': dict(art.stats), 'rank': process_index(),
            'device': str(art.device)}


def record_mesh(device, names=None, inject=None):
    """On a rank of a world: ``{name: record or None}`` of every mesh
    specimen the world is large enough for (see the module docstring).
    ``inject`` (``{name: {...}}``) hands a specimen's build the weights
    and draws to use (the tests' JAX parameters and noise)."""
    from dgmc_tpu_torch.parallel.distributed import process_count
    world = process_count()
    out = {}
    for spec in mesh_specimens(names):
        if spec.min_devices > world:
            continue
        out[spec.name] = record_specimen(spec, device,
                                         (inject or {}).get(spec.name))
    return out


def by_specimen(rank_records):
    """``[{name: record}]`` per rank → ``{name: [records of the ranks
    that ran it, rank order]}``."""
    out = {}
    for recs in rank_records:
        for name, rec in recs.items():
            lst = out.setdefault(name, [])
            if rec is not None:
                lst.append(rec)
    return out


def gather_in_world(device, names=None, inject=None):
    """In a world of enough ranks, every rank's :func:`record_mesh`
    gathered to every rank: ``{name: [records]}``."""
    import torch.distributed as dist
    mine = record_mesh(device, names, inject)
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, pickle.dumps(mine))
    return by_specimen([pickle.loads(p) for p in parts])


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _specimen_at(ref):
    """The specimen a ``'module:function'`` reference builds."""
    module, fn = ref.split(':')
    return getattr(importlib.import_module(module), fn)()


class RankRun:
    """The :data:`DEFAULT_RANKS` local ranks that :func:`start` began;
    :meth:`wait` collects them."""

    def __init__(self, procs, tmp, timeout):
        self.procs = procs
        self.tmp = tmp
        self.timeout = timeout
        self.started = time.time()
        #: Each rank's end on the host's wall clock, rank order (set by
        #: :meth:`wait`).
        self.ended = None
        self._records = None

    def _log(self, r):
        with open(os.path.join(self.tmp, f'rank{r}.log'),
                  errors='replace') as f:
            return f.read()[-4000:]

    def wait(self):
        """``{name: [records]}`` once every rank has ended. A rank that
        fails, or a run past the timeout, stops every rank and raises
        with the rank's output."""
        if self._records is not None:
            return self._records
        deadline = time.monotonic() + self.timeout
        try:
            while True:
                rcs = [p.poll() for p in self.procs]
                bad = [r for r, rc in enumerate(rcs) if rc]
                if bad:
                    raise RuntimeError(
                        f'mesh specimen rank {bad[0]} exited '
                        f'{rcs[bad[0]]}:\n{self._log(bad[0])}')
                if None not in rcs:
                    break
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f'mesh specimen ranks still running after '
                        f'{self.timeout}s:\n{self._log(rcs.index(None))}')
                time.sleep(0.1)
            ranks, self.ended = [], []
            for r in range(len(self.procs)):
                with open(os.path.join(self.tmp, f'rank{r}.pkl'),
                          'rb') as f:
                    got = pickle.load(f)
                ranks.append(got['records'])
                self.ended.append(got['ended'])
            self._records = by_specimen(ranks)
            return self._records
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            shutil.rmtree(self.tmp, ignore_errors=True)


def start(device, extra=(), timeout=900):
    """Start :data:`DEFAULT_RANKS` local ranks on gloo (``python -m
    dgmc_tpu_torch.analysis.ranks``), each pinned to one intra-op thread
    and its output in a file of its own, which run :func:`record_mesh`
    on ``device`` and then each specimen of ``extra`` (``'module:
    function'`` references, each function returning a specimen), without
    waiting for them: → a :class:`RankRun`."""
    tmp = tempfile.mkdtemp(prefix='dgmc_ranks_')
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS='1',
               PYTHONPATH=_ROOT + os.pathsep
               + os.environ.get('PYTHONPATH', ''))
    procs = []
    for r in range(DEFAULT_RANKS):
        with open(os.path.join(tmp, f'rank{r}.log'), 'w') as log:
            procs.append(subprocess.Popen(
                [sys.executable, '-m', 'dgmc_tpu_torch.analysis.ranks', tmp,
                 str(device), str(r), str(port), ','.join(extra)],
                cwd=_ROOT, env=env, stdin=subprocess.DEVNULL, stdout=log,
                stderr=subprocess.STDOUT))
    return RankRun(procs, tmp, timeout)


class MeshRuns:
    """One process's mesh specimen runs on ``device``: started on
    :data:`DEFAULT_RANKS` local ranks at the first request or at
    :meth:`start` (or run in place in a world of enough ranks), once for
    every mesh specimen."""

    def __init__(self, device):
        self.device = device
        self._run = None
        self._records = None

    def in_world(self):
        """Whether this process is in a world of at least
        :data:`DEFAULT_RANKS` ranks (else it starts ranks of its own)."""
        from dgmc_tpu_torch.parallel.distributed import process_count
        return process_count() >= DEFAULT_RANKS

    @property
    def size(self):
        from dgmc_tpu_torch.parallel.distributed import process_count
        return process_count() if self.in_world() else DEFAULT_RANKS

    @property
    def where(self):
        kind = 'ranks of this world' if self.in_world() else \
            'gloo ranks'
        return f'{self.size} {kind} on {self.device}'

    def start(self, extra=()):
        """Start the local ranks now, without waiting (a script that runs
        them beside other work), with :func:`start`'s ``extra``
        specimens: → their :class:`RankRun`."""
        if self._run is None and self._records is None:
            self._run = start(self.device, extra)
        return self._run

    def adopt(self, records):
        """Take ``{name: [records]}`` of ranks already run (the tests'
        ranks, built with JAX's weights) in place of starting them."""
        self._records = dict(records)

    def wait(self):
        """Every specimen's records ``{name: [records]}``."""
        if self._records is None:
            if self.in_world():
                self._records = gather_in_world(self.device)
            else:
                self._records = self.start().wait()
        return self._records

    def records(self, name):
        """The records of specimen ``name``, rank order."""
        return self.wait().get(name, [])


def _main(out_dir, device, rank, port, extra=''):
    import torch
    torch.set_num_threads(1)
    from dgmc_tpu_torch.parallel import distributed
    with distributed.process_group(f'127.0.0.1:{port}', DEFAULT_RANKS,
                                   int(rank), backend='gloo',
                                   device=device):
        out = record_mesh(device)
        for ref in filter(None, extra.split(',')):
            spec = _specimen_at(ref)
            out[spec.name] = record_specimen(spec, device)
    path = os.path.join(out_dir, f'rank{rank}.pkl')
    with open(f'{path}.tmp', 'wb') as f:
        pickle.dump({'records': out, 'ended': time.time()}, f)
    os.replace(f'{path}.tmp', path)


if __name__ == '__main__':
    with contextlib.suppress(BrokenPipeError):
        _main(*sys.argv[1:])
