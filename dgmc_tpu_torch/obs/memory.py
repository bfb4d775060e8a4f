"""Memory telemetry: per-device allocator snapshots beside the host's.

The port of the JAX package's ``dgmc_tpu/obs/memory.py``, with its keys.
:func:`memory_snapshot` reads the caching allocator of every CUDA device
(``torch.cuda.memory_stats``) and the host process's resident set from
``/proc/self/status`` (VmRSS / VmHWM), so a CPU run still records the
memory it used. :func:`captured_memory` takes the place of
``compiled_memory``: the static memory of one captured step
(:class:`~dgmc_tpu_torch.train.compiled.Captured`), its input buffers
and in-place inputs, its static outputs and its graph's private pool.
"""

import resource
import time

import torch

__all__ = ['memory_snapshot', 'captured_memory']


def _device_stats():
    """Per-device allocator stats (empty without CUDA)."""
    if not torch.cuda.is_available():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        rec = {'id': i, 'kind': torch.cuda.get_device_name(i),
               'platform': 'gpu',
               'bytes_limit': int(torch.cuda.get_device_properties(
                   i).total_memory)}
        if stats:
            rec['bytes_in_use'] = int(stats.get('allocated_bytes.all.current',
                                                0))
            rec['peak_bytes_in_use'] = int(stats.get(
                'allocated_bytes.all.peak', 0))
            rec['bytes_reserved'] = int(stats.get(
                'reserved_bytes.all.current', 0))
        else:
            rec['stats'] = None
        out.append(rec)
    return out


def _host_stats():
    """Host process RSS and high-water mark, in bytes."""
    out = {}
    try:
        with open('/proc/self/status') as f:
            for line in f:
                if line.startswith('VmRSS:'):
                    out['rss_bytes'] = int(line.split()[1]) * 1024
                elif line.startswith('VmHWM:'):
                    out['peak_rss_bytes'] = int(line.split()[1]) * 1024
    except OSError:
        pass
    if 'peak_rss_bytes' not in out:
        ru = resource.getrusage(resource.RUSAGE_SELF)
        out['peak_rss_bytes'] = ru.ru_maxrss * 1024  # KiB on Linux
    return out


def memory_snapshot(tag=''):
    """One labelled memory snapshot: ``{'tag', 'time', 'devices',
    'host'}``, device allocator stats beside host RSS."""
    return {'tag': tag, 'time': time.time(),
            'devices': _device_stats(), 'host': _host_stats()}


def _nbytes(tensors):
    """Bytes of distinct storages among ``tensors``."""
    seen, total = set(), 0
    for t in tensors:
        key = (t.device, t.untyped_storage().data_ptr())
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total


def captured_memory(record):
    """Static memory of one captured step: ``argument_bytes`` (its input
    buffers and the inputs it reads in place: parameters, optimizer
    state, a batch uploaded once), ``output_bytes`` (its static
    outputs), ``temp_bytes`` (what its graph's private pool reserved
    beyond the outputs: every intermediate and gradient of the step; 0 on
    the CPU, where nothing is captured) and ``total_bytes``."""
    # Here, not at the top: train.compiled imports the obs package.
    from dgmc_tpu_torch.train.compiled import tensors_of
    args = _nbytes(tensors_of(record.static))
    outs = _nbytes(tensors_of(record.outputs))
    temp = max(record.pool_bytes - outs, 0) if record.graph is not None \
        else 0
    return {'argument_bytes': args, 'output_bytes': outs,
            'temp_bytes': temp, 'total_bytes': args + outs + temp}
