"""The counter-based draws (``dgmc_tpu_torch/ops/kernels/rng.py``, the
plain versions of ``csrc/rng.cu``) and the model's draws built on them
(``models/dgmc.py``: ``draw_noise``, ``draw_negatives``).

Philox4x32-10 is held against Random123's known-answer vectors; the
Box–Muller normals against a direct float64 formula in NumPy on the same
words (bit-equal after the one rounding to float32, tolerance 0); the
moments of 10^6 draws against their distributions (bounds stated per
test, several standard errors wide). The kernel itself is held against
these plain versions on the card (``chip_smoke.py``, ``rng_kernel``; the
``cuda`` test below).
"""

import numpy as np
import pytest
import torch

from dgmc_tpu_torch.models import dgmc as dgmc_module
from dgmc_tpu_torch.ops.kernels import dispatch, rng

#: Random123's known answers for Philox4x32-10: (counter, key) -> block.
KNOWN = [
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff, 0xffffffff),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]


def test_philox_constants_are_random123s():
    assert rng.PHILOX_M == (0xD2511F53, 0xCD9E8D57)
    assert rng.PHILOX_W == (0x9E3779B9, 0xBB67AE85)


@pytest.mark.parametrize('counter,key,want', KNOWN)
def test_philox_known_answers(counter, key, want):
    got = rng.philox4x32(counter, key)
    assert tuple(int(w) for w in got) == want


def test_philox_words_follow_the_counter_layout():
    """Pair ``b``'s block ``q`` sits at counter ``(q, pair_offset + b,
    stream)`` under the seed's two key words, its four words in order."""
    seed = (3 << 32) + 17
    words = rng.plain_philox_words(2, 3, 6, seed, pair_offset=4, stream=1)
    assert words.shape == (3, 12)
    for b in range(3):
        for q in range(3):
            block = rng.philox4x32((q, 0, 4 + b, 1), (17, 3))
            assert words[b, 4 * q:4 * q + 4].tolist() == [int(w)
                                                           for w in block]


def test_uniforms_and_normals_against_a_direct_formula():
    """Uniforms ``(x >> 8) * 2^-24``; normals by Box–Muller in float64 on
    the word pairs, written out in NumPy, rounded once: bit-equal."""
    steps, B, P = 3, 2, 10
    words = rng.plain_philox_words(steps, B, P, 99, 1).numpy()
    u = (words >> 8).astype(np.float64) * 2.0 ** -24
    want_u = np.stack([u[:, :steps * P].reshape(B, steps, P)[:, s]
                       for s in range(steps)]).astype(np.float32)
    np.testing.assert_array_equal(
        rng.plain_philox_uniform(steps, B, P, 99, 1).numpy(), want_u)
    x = words.reshape(B, -1, 4)
    z = []
    for h in (0, 1):
        u1 = ((x[..., 2 * h] >> 8) + 1).astype(np.float64) * 2.0 ** -24
        u2 = (x[..., 2 * h + 1] >> 8).astype(np.float64) * 2.0 ** -24
        r = np.sqrt(-2.0 * np.log(u1))
        z += [r * np.cos(2 * np.pi * u2), r * np.sin(2 * np.pi * u2)]
    flat = np.stack(z, axis=-1).reshape(B, -1)[:, :steps * P]
    want_z = flat.reshape(B, steps, P).transpose(1, 0, 2).astype(np.float32)
    got = rng.plain_philox_normal(steps, B, P, 99, 1).numpy()
    np.testing.assert_array_equal(got, want_z)


def test_a_batch_draws_what_its_pairs_draw_one_at_a_time():
    """Noise and negatives of pair ``b`` at ``pair_offset`` equal pair 0's
    draw alone at ``pair_offset + b`` (the batched-step property that
    ``test_torch_sparse_train.py`` holds on the losses)."""
    z = dgmc_module.draw_noise(3, 4, 11, 5, seed=8, pair_offset=6)
    n_valid = torch.tensor([40, 3, 1, 0])
    neg = dgmc_module.draw_negatives(n_valid, 11, 7, seed=8, pair_offset=6)
    assert z.shape == (3, 4, 11, 5) and z.dtype == torch.float32
    assert neg.shape == (4, 11, 7) and neg.dtype == torch.int64
    for b in range(4):
        one = dgmc_module.draw_noise(3, 1, 11, 5, seed=8, pair_offset=6 + b)
        assert torch.equal(z[:, b:b + 1], one)
        one = dgmc_module.draw_negatives(n_valid[b:b + 1], 11, 7, seed=8,
                                         pair_offset=6 + b)
        assert torch.equal(neg[b:b + 1], one)


def test_streams_are_disjoint():
    """Other streams, pairs and seeds draw other words: no 32-bit word of
    one draw recurs in the others (four draws of 4096 words each; a
    chance collision of 32-bit words has probability ~2e-2 per pair of
    draws, so a few shared words would be noise, a shared block not)."""
    draws = [rng.plain_philox_words(1, 1, 4096, 5, 0, 0),
             rng.plain_philox_words(1, 1, 4096, 5, 0, 1),
             rng.plain_philox_words(1, 1, 4096, 5, 1, 0),
             rng.plain_philox_words(1, 1, 4096, 6, 0, 0)]
    for i in range(4):
        for j in range(i + 1, 4):
            shared = np.intersect1d(draws[i].numpy(), draws[j].numpy())
            assert shared.size <= 2, (i, j, shared.size)
    model_streams = (dgmc_module.NOISE_STREAM, dgmc_module.NEGATIVES_STREAM)
    assert len(set(model_streams)) == 2


def test_negatives_lie_in_the_valid_targets():
    n_valid = torch.tensor([20000, 7, 1, 0])
    neg = dgmc_module.draw_negatives(n_valid, 1000, 10, seed=3)
    assert neg.dtype == torch.int64 and (neg >= 0).all()
    for b, n in enumerate(n_valid.tolist()):
        assert int(neg[b].max()) <= max(n - 1, 0)
    assert set(neg[1].unique().tolist()) == set(range(7))
    # floor(u * n) in float32, clamped: the plain formula.
    u = rng.plain_philox_uniform(1, 4, 10000, 3, 0, 1)[0]
    want = torch.floor(u * n_valid.float()[:, None]).long()
    want = torch.minimum(want, (n_valid - 1).clamp(min=0)[:, None])
    assert torch.equal(neg.reshape(4, -1), want)


def test_moments_of_a_million_draws():
    """10^6 each: uniform mean 1/2 and variance 1/12 within 0.002 (the
    standard errors are 0.0003 and 0.0001), min >= 0, max < 1; normal
    mean 0 and variance 1 within 0.006 (standard errors 0.001 and
    0.0014), third moment within 0.01, fourth 3 within 0.03, and the share
    beyond 3 sigma 0.0027 within 0.0005."""
    u = rng.plain_philox_uniform(1, 1, 10 ** 6, 12345).double()
    assert abs(float(u.mean()) - 0.5) < 0.002
    assert abs(float(u.var()) - 1 / 12) < 0.002
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    z = rng.philox_normal(4, 2, 125000, 12345).double()
    assert abs(float(z.mean())) < 0.006
    assert abs(float(z.var()) - 1.0) < 0.006
    assert abs(float((z ** 3).mean())) < 0.01
    assert abs(float((z ** 4).mean()) - 3.0) < 0.03
    assert abs(float((z.abs() > 3).double().mean()) - 0.0027) < 0.0005


def test_the_cpu_path_takes_the_plain_version_and_records_it():
    dispatch.reset()
    z = rng.philox_normal(2, 3, 5, 7)
    assert torch.equal(z, rng.plain_philox_normal(2, 3, 5, 7))
    d = dispatch.decisions()['rng']
    assert (d['path'], d['reason'], d['dtype']) == ('plain', 'device=cpu',
                                                    'float32')
    assert rng._draw.launches == 0
    rng.philox_negatives(torch.tensor([4]), 3, 7)
    assert dispatch.decisions()['rng']['dtype'] == 'int64'
    with pytest.raises(ValueError, match='counter'):
        rng.philox_normal(1, 2, 3, 0, pair_offset=(1 << 32) - 1)
    with pytest.raises(ValueError, match='cpu or cuda'):
        rng.philox_normal(1, 1, 4, 0, device='meta')


def test_seeds_use_both_key_words():
    a = rng.plain_philox_words(1, 1, 8, 5)
    b = rng.plain_philox_words(1, 1, 8, 5 + (1 << 32))
    c = rng.plain_philox_words(1, 1, 8, 5 - (1 << 64))
    assert not torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize('seed', [0, 12345, (7 << 40) + 3, (1 << 63) + 17,
                                  (1 << 64) - 1])
def test_seed_tensor_draws_the_int_seeds_stream(seed):
    """The key as a 0-d int64 tensor (its bits in two's complement, as a
    captured step reads it on the card) draws the stream of the int seed,
    bit for bit: noise and negatives, keys at and past 2^63 too."""
    key = rng.seed_tensor(seed)
    assert key.dtype == torch.int64 and key.dim() == 0
    assert int(key) & ((1 << 64) - 1) == seed
    assert torch.equal(dgmc_module.draw_noise(3, 2, 7, 5, key, 4),
                       dgmc_module.draw_noise(3, 2, 7, 5, seed, 4))
    n_valid = torch.tensor([9, 1, 0])
    assert torch.equal(dgmc_module.draw_negatives(n_valid, 6, 3, key, 2),
                       dgmc_module.draw_negatives(n_valid, 6, 3, seed, 2))
    with pytest.raises(ValueError, match='0-d int64'):
        rng.philox_normal(1, 1, 4, key.to(torch.int32))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(10, 64, 80, 64), (3, 2, 7, 3)])
def test_kernel_matches_the_plain_version(cuda, shape):
    """On the card: uniforms (negatives over 2^24 targets: the words'
    24 bits) and negatives bit-equal to the CPU plain version, normals
    within one float32 ulp; one launch each."""
    T, B, N, R = shape
    before = rng._draw.launches
    z = dgmc_module.draw_noise(T, B, N, R, seed=4, pair_offset=2,
                               device=cuda)
    want = dgmc_module.draw_noise(T, B, N, R, seed=4, pair_offset=2)
    ulps = (z.cpu().view(torch.int32).long()
            - want.view(torch.int32).long()).abs()
    assert int(ulps.max()) <= 1
    words = rng.philox_negatives(torch.full((B,), 1 << 24, device=cuda),
                                 N * R, 4, 2, 0)
    assert torch.equal(words.cpu(),
                       rng.plain_philox_words(1, B, N * R, 4, 2)[:, :N * R]
                       >> 8)
    n_valid = torch.arange(B) * 5
    neg = dgmc_module.draw_negatives(n_valid.to(cuda), N, R, seed=4)
    assert torch.equal(neg.cpu(), dgmc_module.draw_negatives(n_valid, N, R,
                                                             seed=4))
    assert rng._draw.launches == before + 3
    key = rng.seed_tensor((1 << 63) + 4, cuda)
    assert torch.equal(dgmc_module.draw_noise(T, B, N, R, seed=key,
                                              pair_offset=2, device=cuda),
                       dgmc_module.draw_noise(T, B, N, R, seed=(1 << 63) + 4,
                                              pair_offset=2, device=cuda))
    assert torch.equal(
        dgmc_module.draw_negatives(n_valid.to(cuda), N, R, seed=key),
        dgmc_module.draw_negatives(n_valid.to(cuda), N, R,
                                   seed=(1 << 63) + 4))
