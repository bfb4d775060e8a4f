"""The bf16 top-k's two routes (dgmc_tpu_torch/ops/kernels/topk.py,
csrc/topk.cu) on the CPU: which shapes take the tensor-core tile and the
reason recorded for each that does not, the tile's launch plan, its
shared-memory budget against the source's constants, and the tile's
selection rule modelled in NumPy against the plain version.

The kernels themselves run on the card only (tests/test_torch_kernels.py,
marker ``cuda``; chip_smoke.py's ``bf16_kernels`` phase). Tolerance:
bit-equal, every input is integer-valued (each product and sum is exact
in float32 and in bf16).
"""

import os
import re

import numpy as np
import pytest
import torch

from dgmc_tpu_torch.ops.kernels import dispatch
from dgmc_tpu_torch.ops.kernels.topk import (K_MAX, SMEM_MAX,
                                             TARGETS_PER_TILE,
                                             TC_BLOCK_OVERHEAD_TILES,
                                             TC_C_MAX, TC_K_MAX, TC_ROWS,
                                             TC_STAGES, plain_topk, route,
                                             streaming_topk, tc_launch_plan,
                                             tc_smem_bytes)

BF16 = torch.bfloat16
SOURCE = os.path.join(os.path.dirname(__file__), '..', 'dgmc_tpu_torch',
                      'csrc', 'topk.cu')
MAIN_SHAPE = (1, 15000, 20000, 256, 10)   # B, N_s, N_t, C, k (DBP15K)

# (dtype, B, N_s, N_t, C, k) -> (entry, reason)
ROUTES = [
    ((BF16, *MAIN_SHAPE), ('bf16_tc', 'tensor-core')),
    ((BF16, 1, 17, 20000, 32, 10), ('bf16_tc', 'tensor-core')),
    ((BF16, 2, 300, 700, 200, 16), ('bf16_tc', 'tensor-core')),
    ((BF16, 1, 257, 700, 264, 1), ('bf16_tc', 'tensor-core')),
    ((BF16, 1, 300, 700, 640, 10), ('bf16_tc', 'tensor-core')),
    ((BF16, 1, 40, 20, 8, 9), ('bf16_tc', 'tensor-core')),
    ((BF16, 1, 40, 20, 4, 9), ('bf16_fma', 'fma, C%8!=0')),
    ((BF16, 2, 50, 300, 3, 5), ('bf16_fma', 'fma, C%8!=0')),
    ((BF16, 1, 130, 2000, 7, 10), ('bf16_fma', 'fma, C%8!=0')),
    ((BF16, 1, 300, 700, 648, 10), ('bf16_fma', 'fma, C>640')),
    ((BF16, 1, 300, 700, 256, 17), ('bf16_fma', 'fma, k>16')),
    ((BF16, 2, 130, 1100, 256, K_MAX), ('bf16_fma', 'fma, k>16')),
    ((BF16, 1, 4, 200, 256, K_MAX + 1), ('plain', f'k>{K_MAX}')),
    ((torch.float32, *MAIN_SHAPE), ('f32', 'auto-cuda')),
    ((torch.float32, 1, 4, 200, 256, K_MAX + 1), ('plain', f'k>{K_MAX}')),
]


@pytest.mark.parametrize('args, want', ROUTES)
def test_route_of_each_shape(args, want):
    assert route(*args) == want


def test_route_sends_the_tile_exactly_the_shapes_it_takes():
    for C in range(1, TC_C_MAX + 20):
        for k in range(1, K_MAX + 2):
            entry, reason = route(BF16, 1, 100, 1000, C, k)
            takes = C % 8 == 0 and C <= TC_C_MAX and k <= TC_K_MAX
            assert (entry == 'bf16_tc') == takes, (C, k, entry)
            if entry == 'bf16_tc':
                assert tc_smem_bytes(C) <= SMEM_MAX
            elif k <= K_MAX:
                assert entry == 'bf16_fma' and reason.startswith('fma, ')


def _constants():
    """The integer constexprs of csrc/topk.cu: the FMA kernels' and, under
    ``tc_``, the tensor-core tile's (namespace tc)."""
    with open(SOURCE) as f:
        src = f.read()
    start = src.index('namespace tc {')
    pat = re.compile(r'constexpr (?:int|float) (\w+) = ([-\w.*+ ]+);')
    outer = dict(pat.findall(src[:start]))
    inner = dict(pat.findall(src[start:]))
    ints = {}
    for scope, tag in ((outer, ''), (inner, 'tc_')):
        known = {}
        for name, value in scope.items():   # in order of definition
            expr = re.sub(r'[A-Za-z_]\w*',
                          lambda m: str(known.get(m.group(), m.group())),
                          value)
            if re.fullmatch(r'[\d *+]+', expr):
                known[name] = ints[tag + name] = eval(expr)
    return ints


def test_tile_constants_agree_with_the_source():
    c = _constants()
    assert (c['tc_ROWS'], c['tc_TGT'], c['tc_STAGES'], c['tc_C_MAX'],
            c['tc_K_CAP']) == (TC_ROWS, TARGETS_PER_TILE, TC_STAGES,
                               TC_C_MAX, TC_K_MAX)
    assert c['SMEM_MAX'] == SMEM_MAX and c['K_MAX'] == K_MAX
    # Two consumer warpgroups of 64 rows each; a 64-channel chunk is one
    # 128-byte swizzled row of bf16.
    assert c['tc_CONSUMERS'] == 256 and c['tc_ROWS'] == 2 * 64
    assert c['tc_KC'] * 2 == 128 and c['tc_CHUNK'] == 128 * c['tc_KC'] * 2


@pytest.mark.parametrize('k', [1, 10, TC_K_MAX])
def test_shared_memory_budget_of_every_width_the_tile_takes(k):
    """The source's formula (align + the resident h_s stripe and the ring
    in 16 KB chunks + 9 mbarriers) is the wrapper's, within the 227 KB a
    block may use for every C the route sends to the tile, whatever k
    (the carry lives in registers)."""
    c = _constants()
    for C in range(8, TC_C_MAX + 1, 8):
        assert route(BF16, 1, 100, 1000, C, k)[0] == 'bf16_tc'
        want = (c['tc_ALIGN'] + (-(-C // c['tc_KC']) + c['tc_STAGES'])
                * c['tc_CHUNK'] + 8 * (2 * c['tc_STAGES'] + 1))
        assert tc_smem_bytes(C) == want <= SMEM_MAX
    assert tc_smem_bytes(TC_C_MAX + 64) > SMEM_MAX   # why C stops there


# (B, N_s, N_t, SM count): the DBP15K KG, small queries against its
# target table, a batch of 2, fewer targets than a tile, a smaller card.
TC_PLANS = [(1, 15000, 20000, 132), (1, 17, 20000, 132),
            (1, 64, 20000, 132), (1, 1500, 2000, 132), (2, 130, 1100, 132),
            (1, 40, 20, 132), (1, 200, 3000, 132), (1, 16, 20000, 80),
            (4, 15000, 20000, 132)]


@pytest.mark.parametrize('plan', TC_PLANS)
def test_tc_launch_plan_covers_every_tile_once_and_fills_the_card(plan):
    B, N_s, N_t, sms = plan
    rows, nseg, tps = tc_launch_plan(B, N_s, N_t, sms)
    assert rows == TC_ROWS
    n_tiles = -(-N_t // TARGETS_PER_TILE)
    segs = [list(range(s * tps, min((s + 1) * tps, n_tiles)))
            for s in range(nseg)]
    assert all(segs)                                  # none empty
    assert [t for seg in segs for t in seg] == list(range(n_tiles))
    row_blocks = B * -(-N_s // TC_ROWS)

    def cost(t):   # waves of one block an SM x (tiles + its own cost)
        return (-(-row_blocks * -(-n_tiles // t) // sms)
                * (t + TC_BLOCK_OVERHEAD_TILES))
    assert cost(tps) == min(cost(t) for t in range(1, n_tiles + 1))
    if row_blocks * n_tiles >= sms:
        assert row_blocks * nseg > sms // 2           # spread on the card


def test_tc_launch_plan_at_the_main_shape_is_one_wave():
    """118 blocks of 128 rows on 132 SMs, each over all 157 target tiles:
    any cut of the target axis adds a wave."""
    assert tc_launch_plan(1, 15000, 20000, 132) == (TC_ROWS, 1, 157)


# -- The tile's selection rule, modelled -----------------------------------

NEG = float(torch.finfo(BF16).min)


def _tile_rule_topk(scores, valid_mask, k):
    """The tensor-core tile's selection, in NumPy, on exact (bf16) scores
    [N_s, N_t]: per row a carry of the best TC_K_MAX by key (value
    descending, index ascending); a tile's score is a candidate only if
    it rounds above the carry's k-th value (a masked one scores NEG);
    where a quad (the 4 lanes that hold a row's 128 targets of a tile)
    has more than k candidates, those below the k-th largest of its 16
    group maxima (lane q, group g: targets 8 j + 2 q + c of the tile,
    j in [4 g, 4 g + 4), c in {0, 1}) are dropped; the rest are
    inserted. The answer is the carry's best k."""
    N_s, N_t = scores.shape
    lane_of = np.array([(t % 8) // 2 for t in range(TARGETS_PER_TILE)])
    group_of = np.array([(t // 8) // 4 for t in range(TARGETS_PER_TILE)])
    vals = np.empty((N_s, k), np.float32)
    idx = np.empty((N_s, k), np.int64)
    for r in range(N_s):
        carry = []                                   # [(value, index)]
        thr = -np.inf
        for t0 in range(0, N_t, TARGETS_PER_TILE):
            ts = np.arange(t0, min(t0 + TARGETS_PER_TILE, N_t))
            v = np.where(valid_mask[ts], scores[r, ts], NEG)
            cand = v > thr
            if cand.sum() > k:
                maxima = []
                for q in range(4):
                    for g in range(4):
                        sel = cand & (lane_of[ts - t0] == q) & (
                            group_of[ts - t0] == g)
                        maxima.append(v[sel].max() if sel.any()
                                      else -np.inf)
                theta = np.sort(maxima)[::-1][k - 1]
                cand &= v >= theta
            carry += [(float(v[j]), int(ts[j])) for j in np.nonzero(cand)[0]]
            carry = sorted(carry, key=lambda e: (-e[0], e[1]))[:TC_K_MAX]
            if len(carry) >= k:
                thr = carry[k - 1][0]
        vals[r] = [e[0] for e in carry[:k]]
        idx[r] = [e[1] for e in carry[:k]]
    return vals, idx


# (N_s, N_t, C, k, mask): ties, a ragged last tile, k at both limits,
# k above the valid targets, a fully masked target table and two masked
# tiles.
RULE_CASES = [(6, 700, 8, 10, None), (5, 333, 16, 1, 0.3),
              (4, 1000, 24, TC_K_MAX, 0.5), (3, 20, 8, 9, 'five_valid'),
              (3, 300, 8, 10, 'all'), (3, 600, 8, 10, 'tiles')]


@pytest.mark.parametrize('case', RULE_CASES)
def test_tile_selection_rule_gives_the_plain_top_k(case):
    N_s, N_t, C, k, masked = case
    rng = np.random.RandomState(N_t + k)
    h_s = torch.from_numpy(rng.randint(-2, 3, (1, N_s, C))).to(BF16)
    h_t = torch.from_numpy(rng.randint(-2, 3, (1, N_t, C))).to(BF16)
    if masked is None:
        mask = np.ones(N_t, bool)
    elif masked == 'five_valid':
        mask = np.arange(N_t) < 5
    elif masked == 'all':
        mask = np.zeros(N_t, bool)
    elif masked == 'tiles':
        mask = (np.arange(N_t) < 128) | (np.arange(N_t) >= 384)
    else:
        mask = rng.rand(N_t) > masked
    scores = (h_s[0].float() @ h_t[0].float().T).to(BF16).float().numpy()
    got_v, got_i = _tile_rule_topk(scores, mask, k)
    pv, pi = plain_topk(h_s, h_t, k, torch.from_numpy(mask)[None])
    np.testing.assert_array_equal(got_i, pi[0].numpy())
    np.testing.assert_array_equal(got_v, pv[0].float().numpy())


def test_cpu_bf16_takes_the_plain_path_whatever_the_route():
    """On the CPU the wrapper runs the plain version (no kernel), for a
    shape of either route, and records it so."""
    for C, k in ((256, 10), (12, 10), (64, 17)):
        h_s, h_t = torch.ones(1, 4, C, dtype=BF16), torch.ones(
            1, 40, C, dtype=BF16)
        before = streaming_topk.launches
        v, i = streaming_topk(h_s, h_t, k)
        assert streaming_topk.launches == before
        d = dispatch.decisions()['topk']
        assert (d['path'], d['reason'], d['dtype']) == ('plain',
                                                        'device=cpu',
                                                        'bfloat16')
        assert torch.equal(i[0, 0], torch.arange(k, dtype=torch.int32))
