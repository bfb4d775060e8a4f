"""The port's CUDA kernels against their plain versions on the card.

Imports torch and the port only (no JAX), so it also runs on a machine
with a GPU and no JAX, without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda

Without a CUDA device every test here skips. Tolerance: indices and
values bit-equal, since every input is integer-valued (each product and
partial sum is an exact small integer in float32).
"""

import numpy as np
import pytest
import torch

from dgmc_tpu_torch.ops.kernels import dispatch
from dgmc_tpu_torch.ops.kernels.topk import (K_MAX, plain_topk,
                                             streaming_topk)

# (B, N_s, N_t, C, k, masked share): ties, tile boundaries, segments,
# k above the valid targets and k at the kernel's limit.
CASES = [(2, 300, 700, 8, 7, 0.3), (1, 64, 64, 8, 3, None),
         (1, 65, 65, 8, 3, None), (1, 16, 5000, 32, 10, 0.5),
         (1, 40, 20, 4, 9, 0.8), (1, 200, 3000, 32, K_MAX, 0.9)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('case', CASES)
def test_topk_kernel_matches_plain(cuda, case):
    B, N_s, N_t, C, k, masked = case
    rng = np.random.RandomState(N_s + N_t)
    h_s = torch.from_numpy(rng.randint(-2, 3, (B, N_s, C)).astype(
        np.float32)).to(cuda)
    h_t = torch.from_numpy(rng.randint(-2, 3, (B, N_t, C)).astype(
        np.float32)).to(cuda)
    mask = (None if masked is None
            else torch.from_numpy(rng.rand(B, N_t) > masked).to(cuda))
    before = streaming_topk.launches
    v, i = streaming_topk(h_s, h_t, k, mask)
    torch.cuda.synchronize()
    assert streaming_topk.launches == before + 1
    assert dispatch.decisions()['topk']['path'] == 'kernel'
    pv, pi = plain_topk(h_s, h_t, k, mask)
    assert torch.equal(i, pi) and torch.equal(v, pv)


@pytest.mark.cuda
def test_topk_kernel_rejects_other_dtypes(cuda):
    h = torch.zeros(1, 8, 4, dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        streaming_topk(h, h, 2)


@pytest.mark.cuda
def test_topk_above_k_max_is_a_recorded_plain_dispatch(cuda):
    h_s = torch.ones(1, 4, 4, device=cuda)
    h_t = torch.ones(1, K_MAX + 5, 4, device=cuda)
    before = streaming_topk.launches
    _, idx = streaming_topk(h_s, h_t, K_MAX + 1)
    d = dispatch.decisions()['topk']
    assert (d['path'], d['reason']) == ('plain', f'k>{K_MAX}')
    assert streaming_topk.launches == before
    assert torch.equal(idx[0, 0].cpu(), torch.arange(K_MAX + 1,
                                                     dtype=torch.int32))
