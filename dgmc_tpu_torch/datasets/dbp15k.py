"""DBP15K cross-lingual knowledge-graph alignment.

Per language pair (``zh_en``, ``ja_en``, ``fr_en``) two KGs of 15000 to
20000 entities, per-entity word-vector features, directed relation edges
and the train / test alignments, parsed from the JAPE release's raw
layout as the JAX package's ``dgmc_tpu/datasets/dbp15k.py`` parses it::

    <root>/<pair>/triples_1, triples_2      head rel tail (global ids)
    <root>/<pair>/ent_ids_1, ent_ids_2      global id <tab> uri
    <root>/<pair>/sup_pairs | sup_ent_ids   train alignments (id1 id2)
    <root>/<pair>/ref_pairs | ref_ent_ids   test alignments
    <root>/<pair>/<lang>_vectorList.json    per-entity vectors by global
                                            id (or one vectorList.json),
    or the caches ``x1.npy`` / ``x2.npy`` in the same directory.

Local indices are the line order of ``ent_ids_*``. Nothing is
downloaded.
"""

import json
import os

import numpy as np

from dgmc_tpu_torch.utils.data import Graph

__all__ = ['PAIRS', 'DBP15K']

PAIRS = ('zh_en', 'ja_en', 'fr_en')


def _read_columns(path, n):
    with open(path) as f:
        return [tuple(int(v) for v in line.split()[:n]) for line in f
                if line.strip()]


class DBP15K:
    """One language pair of DBP15K.

    Attributes: ``x1``, ``x2`` ``[N, W, D]`` float32 word vectors
    (W >= 1); ``edge_index1``, ``edge_index2`` ``[2, E]`` int64 directed
    edges and ``rel1``, ``rel2`` ``[E]`` their relation ids (triples
    whose endpoints are not listed are dropped); ``train_y``, ``test_y``
    ``[2, M]`` int64 alignments in local indices.
    """

    def __init__(self, root, pair, download=False):
        if pair not in PAIRS:
            raise ValueError(f'pair must be one of {PAIRS}, got {pair!r}')
        self.root = os.path.expanduser(root)
        self.pair = pair
        d = os.path.join(self.root, pair)
        if not os.path.isdir(d):
            if download:
                raise NotImplementedError(
                    'downloads are not ported: extract the DBP15K (JAPE) '
                    f'release so that {d}/triples_1 exists')
            raise FileNotFoundError(
                f'DBP15K raw data not found at {d}. Download the '
                f'DBP15K (JAPE) release and extract it so that '
                f'{d}/triples_1 exists.')
        self._load(d)

    def _load(self, d):
        ids1 = [r[0] for r in _read_columns(os.path.join(d, 'ent_ids_1'), 1)]
        ids2 = [r[0] for r in _read_columns(os.path.join(d, 'ent_ids_2'), 1)]
        self.g2l_1 = {g: i for i, g in enumerate(ids1)}
        self.g2l_2 = {g: i for i, g in enumerate(ids2)}

        def localize(name, g2l):
            kept = [(g2l[h], g2l[t], r) for h, r, t in
                    _read_columns(os.path.join(d, name), 3)
                    if h in g2l and t in g2l]
            if not kept:
                return np.zeros((2, 0), np.int64), np.zeros(0, np.int64)
            arr = np.array(kept, np.int64)
            return np.ascontiguousarray(arr[:, :2].T), arr[:, 2]

        self.edge_index1, self.rel1 = localize('triples_1', self.g2l_1)
        self.edge_index2, self.rel2 = localize('triples_2', self.g2l_2)

        def read_split(names):
            for n in names:
                p = os.path.join(d, n)
                if os.path.exists(p):
                    return np.array(
                        [(self.g2l_1[a], self.g2l_2[b])
                         for a, b in _read_columns(p, 2)
                         if a in self.g2l_1 and b in self.g2l_2],
                        np.int64).T
            raise FileNotFoundError(f'none of {names} found in {d}')

        self.train_y = read_split(['sup_pairs', 'sup_ent_ids'])
        self.test_y = read_split(['ref_pairs', 'ref_ent_ids'])
        lang1, lang2 = self.pair.split('_')
        self.x1 = self._features(d, lang1, ids1, 'x1')
        self.x2 = self._features(d, lang2, ids2, 'x2')

    def _features(self, d, lang, ids, cache_name):
        cache = os.path.join(d, f'{cache_name}.npy')
        if os.path.exists(cache):
            x = np.load(cache).astype(np.float32)
        else:
            vec_path = os.path.join(d, f'{lang}_vectorList.json')
            if not os.path.exists(vec_path):
                vec_path = os.path.join(d, 'vectorList.json')
            if not os.path.exists(vec_path):
                raise FileNotFoundError(
                    f'no entity features: expected {cache} or a '
                    f'vectorList.json in {d}')
            with open(vec_path) as f:
                vecs = np.asarray(json.load(f), np.float32)
            x = vecs[np.asarray(ids)]
        if x.ndim == 2:           # one vector per entity: W = 1
            x = x[:, None, :]
        return x

    @property
    def num_nodes1(self):
        return self.x1.shape[0]

    @property
    def num_nodes2(self):
        return self.x2.shape[0]

    def graphs(self, sum_embedding=True):
        """The two KGs as host graphs (the word axis summed when
        ``sum_embedding``, the reference's ``SumEmbedding``)."""
        def build(x, e):
            feats = x.sum(axis=1) if sum_embedding else x
            return Graph(edge_index=e, x=feats.astype(np.float32))
        return (build(self.x1, self.edge_index1),
                build(self.x2, self.edge_index2))

    def __repr__(self):
        return (f'DBP15K({self.pair}, N1={self.num_nodes1}, '
                f'N2={self.num_nodes2})')
