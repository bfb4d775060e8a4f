"""Native (C++) host collation through ctypes: the port's own copy of the
JAX package's ``dgmc_tpu/native`` (``collate.cpp`` and its binding).

The shared library is compiled at first use with the system ``g++``
(``-O3 -shared -fPIC``) into the gitignored ``dgmc_tpu_torch/_build/``,
under a name that carries the hash of the source and the flags, so an
edited source is rebuilt and nothing is built beside the sources or at
import. Without a compiler :func:`load_library` returns ``None`` and
:func:`~dgmc_tpu_torch.utils.data.pad_graphs` takes its NumPy path
(``native='auto'``) or raises (``'require'``).
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

__all__ = ['CXX_FLAGS', 'load_library', 'available', 'pad_graphs_native',
           'pad_ground_truth_native']

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, 'collate.cpp')
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), '_build')

CXX_FLAGS = ('-O3', '-shared', '-fPIC')

_lock = threading.Lock()
_lib = None
_tried = False


def _build():
    """Compile the source (once per content hash) and return the path."""
    with open(_SRC, 'rb') as f:
        digest = hashlib.sha256(repr(CXX_FLAGS).encode() + f.read())
    out = os.path.join(_BUILD_DIR,
                       f'libcollate_{digest.hexdigest()[:16]}.so')
    if not os.path.isfile(out):
        cxx = shutil.which('g++')
        if cxx is None:
            raise OSError('g++ not found')
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f'{out}.tmp.{os.getpid()}'
        subprocess.run([cxx, *CXX_FLAGS, '-o', tmp, _SRC], check=True,
                       capture_output=True)
        os.replace(tmp, out)
    return out


def load_library():
    """The collation library, building it on first use; None if
    unavailable (no compiler, or the build failed)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(_build())
        except (OSError, subprocess.CalledProcessError):
            return None
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.pad_graph_batch.restype = ctypes.c_int
        lib.pad_graph_batch.argtypes = [
            i64, i64, i64, i64, i64,
            p, p,                     # node_off, edge_off
            p, p, p, p,               # x, senders, receivers, eattr
            p, p, p, p, p, p,         # the outputs
        ]
        lib.pad_ground_truth.restype = None
        lib.pad_ground_truth.argtypes = [i64, i64, p, p, p, p]
        _lib = lib
        return _lib


def available():
    return load_library() is not None


def _ptr(a):
    return None if a is None else a.ctypes.data


def _offsets(counts):
    """``[B + 1]`` int64 offsets of consecutive runs of ``counts``."""
    off = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=off[1:])
    return off


def _rows(arrays, counts, width, dtype):
    """The arrays (``[count, width]`` each, None for zeros) concatenated
    into one contiguous ``[sum(counts), width]`` buffer, or None when all
    are None."""
    if all(a is None for a in arrays):
        return None
    return np.concatenate(
        [np.zeros((n, width), dtype) if a is None else a
         for a, n in zip(arrays, counts)]).astype(dtype, copy=False)


def pad_graphs_native(graphs, num_nodes, num_edges, feat_dim, edge_dim):
    """The C++ counterpart of the NumPy loop in
    :func:`dgmc_tpu_torch.utils.data.pad_graphs`: the padded arrays dict
    (``edge_attr`` None without edge attributes), or None when the library
    is unavailable. Each field of the batch goes over as one contiguous
    buffer with per-graph offsets. A width mismatch raises (the C++ copies
    ``feat_dim``/``edge_dim``-wide rows unchecked), as does a graph over
    the padding."""
    lib = load_library()
    if lib is None:
        return None

    B = len(graphs)
    for i, g in enumerate(graphs):
        if g.x is not None and (g.x.ndim != 2 or g.x.shape[1] != feat_dim):
            raise ValueError(f'graph {i}: x has shape {g.x.shape}, expected '
                             f'[*, {feat_dim}]')
        if g.edge_attr is not None and (
                g.edge_attr.ndim != 2 or edge_dim is None
                or g.edge_attr.shape[1] != edge_dim):
            raise ValueError(f'graph {i}: edge_attr has shape '
                             f'{g.edge_attr.shape}, expected '
                             f'[*, {edge_dim}]')
    ns = [g.num_nodes for g in graphs]
    es = [g.num_edges for g in graphs]
    x_in = _rows([g.x for g in graphs], ns, feat_dim, np.float32)
    ei = np.concatenate([g.edge_index for g in graphs],
                        axis=1).astype(np.int64, copy=False)
    ei = np.ascontiguousarray(ei)
    ea_in = (_rows([g.edge_attr for g in graphs], es, edge_dim, np.float32)
             if edge_dim else None)

    x = np.zeros((B, num_nodes, feat_dim), np.float32)
    snd = np.zeros((B, num_edges), np.int32)
    rcv = np.zeros((B, num_edges), np.int32)
    node_mask = np.zeros((B, num_nodes), np.uint8)
    edge_mask = np.zeros((B, num_edges), np.uint8)
    eattr = (np.zeros((B, num_edges, edge_dim), np.float32)
             if edge_dim else None)

    # The buffers are bound to names: ctypes gets bare addresses.
    node_off, edge_off = _offsets(ns), _offsets(es)
    rc = lib.pad_graph_batch(
        B, num_nodes, num_edges, feat_dim, edge_dim or 0,
        _ptr(node_off), _ptr(edge_off), _ptr(x_in), _ptr(ei[0]),
        _ptr(ei[1]), _ptr(ea_in), _ptr(x), _ptr(snd), _ptr(rcv),
        _ptr(node_mask), _ptr(edge_mask), _ptr(eattr))
    if rc != 0:
        g = graphs[rc - 1]
        raise ValueError(f'graph {rc - 1} ({g.num_nodes} nodes / '
                         f'{g.num_edges} edges) exceeds padding '
                         f'({num_nodes} / {num_edges})')
    return dict(x=x, senders=snd, receivers=rcv,
                node_mask=node_mask.view(bool),
                edge_mask=edge_mask.view(bool), edge_attr=eattr)


def pad_ground_truth_native(y_cols, num_nodes):
    """C++ ground-truth padding: per-pair ``y_col`` arrays (or None) →
    ``(y [B, N] int32, y_mask [B, N] bool)``; None if unavailable. A
    ``y_col`` longer than ``num_nodes`` raises (the C++ would write past
    its row)."""
    lib = load_library()
    if lib is None:
        return None
    B = len(y_cols)
    lens = [0 if y is None else len(y) for y in y_cols]
    for b, n in enumerate(lens):
        if n > num_nodes:
            raise ValueError(f'pair {b}: ground truth for {n} source nodes '
                             f'exceeds padding ({num_nodes})')
    cols = [y for y in y_cols if y is not None]
    flat = (np.concatenate(cols).astype(np.int64, copy=False) if cols
            else np.zeros(0, np.int64))
    y = np.empty((B, num_nodes), np.int32)
    mask = np.empty((B, num_nodes), np.uint8)
    off = _offsets(lens)
    lib.pad_ground_truth(B, num_nodes, _ptr(off), _ptr(flat), _ptr(y),
                         _ptr(mask))
    return y, mask.view(bool)
