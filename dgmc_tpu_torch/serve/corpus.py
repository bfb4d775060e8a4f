"""Corpus index: ψ₁ embeddings computed once, cached to disk, verified.

A :class:`Corpus` is the host-side target graph (entity features +
edges); a :class:`CorpusIndex` is that graph plus its ψ₁ embedding
table ``h_t [1, N_t, C]`` under specific weights. The table is a pure
function of ``(corpus, ψ₁ weights)``, so it is computed once and
persisted under a sha256-checksummed manifest: a restarted worker
re-hashes the cache against the manifest and matches the recorded
corpus/parameter fingerprints before trusting it, so a cache from other
weights, another corpus, or a torn write is rebuilt — never served.
"""

import dataclasses
import hashlib
import json
import os
import time
import numpy as np
import torch

from dgmc_tpu_torch import resolve_device
from dgmc_tpu_torch.utils.io import sha256_file, write_json_atomic

__all__ = ['Corpus', 'CorpusIndex', 'synthetic_corpus', 'params_fingerprint',
           'compute_embeddings', 'load_or_build', 'CACHE_MANIFEST',
           'CACHE_TABLE']

#: Cache directory contents: the embedding table and its manifest.
CACHE_TABLE = 'h_t.npy'
CACHE_MANIFEST = 'manifest.json'


def _sha256_bytes(*chunks):
    h = hashlib.sha256()
    for c in chunks:
        h.update(c)
    return h.hexdigest()


@dataclasses.dataclass
class Corpus:
    """Host-side target corpus: the graph queries are matched INTO."""
    x: np.ndarray          # [N_t, C] float32 entity features
    senders: np.ndarray    # [E_t] int32
    receivers: np.ndarray  # [E_t] int32

    @property
    def num_nodes(self):
        return self.x.shape[0]

    @property
    def num_edges(self):
        return self.senders.shape[0]

    @property
    def feat_dim(self):
        return self.x.shape[1]

    def fingerprint(self):
        """Content hash of the corpus arrays (shape-delimited)."""
        return _sha256_bytes(
            repr((self.x.shape, self.senders.shape)).encode(),
            np.ascontiguousarray(self.x).tobytes(),
            np.ascontiguousarray(self.senders.astype(np.int32)).tobytes(),
            np.ascontiguousarray(
                self.receivers.astype(np.int32)).tobytes())

    def graph_arrays(self, dummy_x=True):
        """The padded-batch arrays (B=1) of the corpus graph.

        ``dummy_x=True`` (the serving default) ships a width-1 zero
        feature array: with a precomputed ``h_t`` the model never reads
        the target features, so they stay off the device.
        """
        n, e = self.num_nodes, self.num_edges
        x = (np.zeros((1, n, 1), np.float32) if dummy_x
             else self.x[None].astype(np.float32))
        return {'x': x,
                'senders': self.senders[None].astype(np.int32),
                'receivers': self.receivers[None].astype(np.int32),
                'node_mask': np.ones((1, n), bool),
                'edge_mask': np.ones((1, e), bool)}


def synthetic_corpus(num_nodes, num_edges, dim, seed=0):
    """Unit-norm-feature synthetic corpus."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(num_nodes, dim) / np.sqrt(dim)).astype(np.float32)
    snd = rng.randint(0, num_nodes, num_edges).astype(np.int32)
    rcv = rng.randint(0, num_nodes, num_edges).astype(np.int32)
    return Corpus(x=x, senders=snd, receivers=rcv)


def params_fingerprint(module):
    """Content hash of a module's ``state_dict`` (names, shapes, dtypes
    and bytes): the key tying a corpus cache to the exact weights that
    produced it."""
    h = hashlib.sha256()
    for name, t in sorted(module.state_dict().items()):
        arr = t.detach().cpu().contiguous().numpy()
        h.update(name.encode())
        h.update(repr((arr.shape, str(arr.dtype))).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


@dataclasses.dataclass
class CorpusIndex:
    """A corpus plus its ψ₁ embedding table under one set of weights."""
    corpus: Corpus
    h_t: np.ndarray                 # [1, N_t, C_out] float32
    meta: dict

    @property
    def embed_dim(self):
        return self.h_t.shape[-1]


def compute_embeddings(psi_1, corpus, device=None):
    """``h_t = ψ₁(corpus)`` through the model's own backbone → numpy
    ``[1, N_t, C]`` float32. Runs on ``device`` (CUDA by default);
    ``psi_1`` is moved there."""
    from dgmc_tpu_torch.ops.graph import GraphBatch
    dev = resolve_device(device)
    g = GraphBatch.from_numpy(corpus.graph_arrays(dummy_x=False), dev)
    psi_1.to(dev)
    was_training = psi_1.training
    psi_1.eval()
    try:
        with torch.inference_mode():
            h = psi_1(g.x, g)
    finally:
        psi_1.train(was_training)
    return h.float().cpu().numpy()


def write_cache(cache_dir, index):
    """Persist ``h_t`` + manifest atomically (tmp+rename both)."""
    os.makedirs(cache_dir, exist_ok=True)
    table_path = os.path.join(cache_dir, CACHE_TABLE)
    tmp = table_path + '.tmp'
    with open(tmp, 'wb') as f:
        np.save(f, index.h_t)
    os.replace(tmp, table_path)
    manifest = dict(index.meta)
    manifest['files'] = {CACHE_TABLE: {
        'sha256': sha256_file(table_path),
        'bytes': os.path.getsize(table_path)}}
    write_json_atomic(os.path.join(cache_dir, CACHE_MANIFEST), manifest,
                      indent=1, sort_keys=True)
    return table_path


def load_cache(cache_dir, corpus_fp, params_fp):
    """``(h_t, meta)`` when the cache verifies, else ``(None, reason)``:
    the manifest must parse, every manifested file must re-hash to its
    recorded sha256/size, and the recorded corpus/params fingerprints
    must match the current corpus and weights."""
    mpath = os.path.join(cache_dir, CACHE_MANIFEST)
    try:
        with open(mpath) as f:
            meta = json.load(f)
    except FileNotFoundError:
        return None, 'no-manifest'
    except (OSError, ValueError) as e:
        return None, f'manifest-unreadable:{type(e).__name__}'
    if meta.get('corpus_fingerprint') != corpus_fp:
        return None, 'corpus-mismatch'
    if meta.get('params_fingerprint') != params_fp:
        return None, 'params-mismatch'
    for rel, want in (meta.get('files') or {}).items():
        p = os.path.join(cache_dir, rel)
        if not os.path.isfile(p):
            return None, f'missing:{rel}'
        if os.path.getsize(p) != want.get('bytes'):
            return None, f'size-mismatch:{rel}'
        if sha256_file(p) != want.get('sha256'):
            return None, f'sha256-mismatch:{rel}'
    try:
        h_t = np.load(os.path.join(cache_dir, CACHE_TABLE))
    except (OSError, ValueError) as e:
        return None, f'table-unreadable:{type(e).__name__}'
    return h_t, meta


def load_or_build(cache_dir, psi_1, corpus, device=None, log=None,
                  checkpoint_step=None):
    """The worker's startup path: verified cache hit, or build + persist.

    Returns ``(CorpusIndex, info)`` with
    ``info = {'cache': 'hit' | 'miss:<reason>', 'seconds': ...}``.
    ``cache_dir=None`` disables the cache. ``checkpoint_step``, the step
    the weights were restored from, is recorded in the meta of a table
    built here (the parameters' fingerprint is what a hit must match).
    """
    corpus_fp = corpus.fingerprint()
    params_fp = params_fingerprint(psi_1)
    t0 = time.perf_counter()
    if cache_dir:
        h_t, meta_or_reason = load_cache(cache_dir, corpus_fp, params_fp)
        if h_t is not None:
            info = {'cache': 'hit',
                    'seconds': round(time.perf_counter() - t0, 3)}
            if log:
                log(f'corpus cache HIT: {cache_dir} ({h_t.nbytes >> 20} '
                    f'MiB table verified in {info["seconds"]:.3f}s)')
            return CorpusIndex(corpus, h_t, meta_or_reason), info
        reason = meta_or_reason
    else:
        reason = 'disabled'
    h_t = compute_embeddings(psi_1, corpus, device=device)
    build_s = round(time.perf_counter() - t0, 3)
    meta = {
        'version': 1,
        'corpus_fingerprint': corpus_fp,
        'params_fingerprint': params_fp,
        'checkpoint_step': checkpoint_step,
        'shape': list(h_t.shape),
        'dtype': str(h_t.dtype),
        'built_unix': round(time.time(), 3),
        'build_s': build_s,
    }
    index = CorpusIndex(corpus, h_t, meta)
    if cache_dir:
        write_cache(cache_dir, index)
    info = {'cache': f'miss:{reason}', 'seconds': build_s}
    if log:
        log(f'corpus cache MISS ({reason}): built {h_t.nbytes >> 20} MiB '
            f'table in {build_s:.3f}s'
            + (f', persisted to {cache_dir}' if cache_dir else ''))
    return index, info
