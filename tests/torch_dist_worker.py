"""Run a function on several ranks of a gloo process group, each a fresh
CPU process pinned to one intra-op thread, for the port's parallel tests.

``run_ranks(fn, world, *args)`` starts ``world`` processes of
``python -m tests.torch_dist_worker``, each of which joins the group over
``tcp://127.0.0.1:<free port>``, calls ``fn(*args)`` (``fn`` named as
``'module:function'``) and saves what it returns; the results come back
as a list in rank order. The processes import torch and the port only
(never JAX), so the test process keeps JAX's reference to itself.
"""

import contextlib
import os
import pickle
import socket
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def run_ranks(fn, world, *args, timeout=120):
    """``[fn(*args) on rank r for r in range(world)]`` (see the module
    docstring). A rank that fails raises with its standard error."""
    return run_groups([(fn, world, args)], timeout)[0]


def run_groups(jobs, timeout=120):
    """:func:`run_ranks` of each ``(fn, world, args)`` of ``jobs``, the
    groups side by side; their results in order."""
    with contextlib.ExitStack() as stack:
        started = [_start(stack, fn, world, args) for fn, world, args in jobs]
        return [_finish(*s, timeout) for s in started]


def _start(stack, fn, world, args):
    tmp = stack.enter_context(tempfile.TemporaryDirectory())
    with open(os.path.join(tmp, 'args.pkl'), 'wb') as f:
        pickle.dump(args, f)
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS='1',
               PYTHONPATH=ROOT + os.pathsep + os.environ.get('PYTHONPATH',
                                                             ''))
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'tests.torch_dist_worker', fn, str(world),
         str(r), str(port), tmp], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    return fn, world, tmp, procs


def _finish(fn, world, tmp, procs, timeout):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode:
            raise RuntimeError(f'rank {r} of {fn} exited {p.returncode}:'
                               f'\n{err[-4000:]}')
    results = []
    for r in range(world):
        with open(os.path.join(tmp, f'rank{r}.pkl'), 'rb') as f:
            results.append(pickle.load(f))
    return results


def _main(fn, world, rank, port, tmp):
    import importlib

    import torch
    torch.set_num_threads(1)
    from dgmc_tpu_torch.parallel import distributed
    with open(os.path.join(tmp, 'args.pkl'), 'rb') as f:
        args = pickle.load(f)
    module, name = fn.split(':')
    func = getattr(importlib.import_module(module), name)
    with distributed.process_group(f'127.0.0.1:{port}', int(world),
                                   int(rank), backend='gloo', device='cpu'):
        out = func(*args)
    with open(os.path.join(tmp, f'rank{rank}.pkl'), 'wb') as f:
        pickle.dump(out, f)


if __name__ == '__main__':
    _main(*sys.argv[1:])
