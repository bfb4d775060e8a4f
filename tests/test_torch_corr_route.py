"""The port's scatter-free candidate routing (dgmc_tpu_torch/ops/
corr_route.py) held against the JAX package's (dgmc_tpu/ops/
corr_route.py) on the CPU, on seeded numpy inputs.

Tolerances, stated per check:

- ``build_corr_route``'s JAX fields (``ent``, ``src``, ``dst_local``,
  ``mask``, ``range_id``, ``rows``, ``num_ranges``, ``n_t``): equal bit for
  bit, dtypes and shapes included, over seeds and (rows, block_entries)
  in {(8, 16), (16, 64), (128, 512)}, with duplicates in a row, a hub
  target and padded source rows.
- the row table (``row_ptr``, ``row_ent``, ``row_src``): equal to a
  pure-Python walk of JAX's blocks in order (every target's entries in
  the blocks' order) and holding every candidate.
- ``sparse_project`` / ``sparse_gather`` values and the gradients of
  ``sum(sin(out))`` / ``sum(out * w)``: within rtol 1e-5 / atol 1e-5 of
  JAX's (``jax.vjp``); the gather's values bit-equal.
- the scaled ``ordered_aggregate`` (the kernel's reference): bit-equal to
  the scaled plain version on integer rows and quarter scales (every sum
  exact), within rtol 1e-5 / atol 1e-5 x max|out| on random float32 rows;
  with bf16 rows (C = 64, the scale and product rounded to bf16) bit-equal
  to the plain version on exact values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgmc_tpu.ops import corr_route as jc
from dgmc_tpu_torch.ops import blocked as tb
from dgmc_tpu_torch.ops import corr_route as tc
from dgmc_tpu_torch.ops.kernels import blocked as kb
from dgmc_tpu_torch.ops.kernels import dispatch

N_T = 53


@pytest.fixture(autouse=True)
def _one_intra_op_thread():
    """One intra-op thread: small tensors, parallel test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(seed, B=2, N_s=37, K=5, n_t=N_T, R=7, hub=False, padded=False):
    """JAX's ``_random_case`` (tests/ops/test_corr_route.py:18-28): a
    duplicate in every third row; optionally a hub target (node 3 in
    most rows of element 0) and padded source rows (element 1's last 8
    rows, their S zero as the model's row mask makes it)."""
    rng = np.random.RandomState(seed)
    S_idx = rng.randint(0, n_t, (B, N_s, K)).astype(np.int32)
    S_idx[:, ::3, -1] = S_idx[:, ::3, 0]
    if hub:
        S_idx[0, 10:] = 3
    S = rng.randn(B, N_s, K).astype(np.float32)
    if padded:
        S[1, -8:] = 0
    r_s = rng.randn(B, N_s, R).astype(np.float32)
    feat = rng.randn(B, n_t, R).astype(np.float32)
    return S_idx, S, r_s, feat


def _routes(S_idx, n_t=N_T, **kw):
    return (jc.build_corr_route(jnp.asarray(S_idx), n_t, **kw),
            tc.build_corr_route(torch.from_numpy(S_idx), n_t, **kw))


BLOCKINGS = [(8, 16), (16, 64), (128, 512)]


@pytest.mark.parametrize('seed', [0, 1, 2])
@pytest.mark.parametrize('rows,block_entries', BLOCKINGS)
@pytest.mark.parametrize('kind', ['plain', 'hub', 'padded'])
def test_build_corr_route_fields_equal_jax(seed, rows, block_entries, kind):
    S_idx, *_ = _case(seed, hub=kind == 'hub', padded=kind == 'padded')
    jr, tr = _routes(S_idx, rows=rows, block_entries=block_entries)
    for f in ('ent', 'src', 'dst_local', 'mask', 'range_id'):
        want = np.asarray(getattr(jr, f))
        got = getattr(tr, f).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    assert (tr.rows, tr.num_ranges, tr.n_t) == (jr.rows, jr.num_ranges,
                                                jr.n_t)


@pytest.mark.parametrize('rows,block_entries', BLOCKINGS)
@pytest.mark.parametrize('hub', [False, True])
def test_row_table_is_the_walk_of_jax_blocks(rows, block_entries, hub):
    """Each target's entries in the order of JAX's blocks (blocks in
    order, slots in order), every candidate present once."""
    S_idx, *_ = _case(5, hub=hub)
    jr, tr = _routes(S_idx, rows=rows, block_entries=block_entries)
    ent, mask = np.asarray(jr.ent), np.asarray(jr.mask)
    dst = (np.asarray(jr.range_id)[..., None] * rows
           + np.asarray(jr.dst_local))
    B, N_s, K = S_idx.shape
    for b in range(B):
        per = [[] for _ in range(N_T)]
        for blk in range(ent.shape[1]):
            for e in range(ent.shape[2]):
                if mask[b, blk, e]:
                    per[dst[b, blk, e]].append(int(ent[b, blk, e]))
        ptr = np.cumsum([0] + [len(p) for p in per])
        flat = [e for p in per for e in p]
        np.testing.assert_array_equal(tr.row_ptr[b].numpy(), ptr)
        np.testing.assert_array_equal(tr.row_ent[b].numpy(), flat)
        np.testing.assert_array_equal(tr.row_src[b].numpy(),
                                      np.asarray(flat) // K)
        assert sorted(flat) == list(range(N_s * K))
    for f in ('row_ptr', 'row_ent', 'row_src'):
        assert getattr(tr, f).dtype == torch.int32


def _project_ref(S, r_s, S_idx):
    """The segment-sum truth (JAX's ``_project_ref``)."""
    B, N_s, K = S_idx.shape
    contrib = (S[..., None] * r_s[:, :, None, :]).reshape(
        B, N_s * K, r_s.shape[-1])
    return jax.vmap(lambda c, i: jax.ops.segment_sum(
        c, i, num_segments=N_T))(contrib, S_idx.reshape(B, N_s * K))


@pytest.mark.parametrize('seed', [0, 1])
@pytest.mark.parametrize('rows,block_entries', BLOCKINGS)
@pytest.mark.parametrize('kind', ['plain', 'hub', 'padded'])
def test_sparse_project_values_and_gradients_match_jax(seed, rows,
                                                       block_entries, kind):
    S_idx, S, r_s, _ = _case(seed, hub=kind == 'hub',
                             padded=kind == 'padded')
    jr, tr = _routes(S_idx, rows=rows, block_entries=block_entries)
    want, vjp = jax.vjp(lambda a, b: jc.sparse_project(
        a, b, jnp.asarray(S_idx), jr), jnp.asarray(S), jnp.asarray(r_s))
    cot = np.cos(np.asarray(want))   # d sum(sin(out))
    want_dS, want_drs = vjp(jnp.asarray(cot))
    St = torch.from_numpy(S).requires_grad_()
    rt = torch.from_numpy(r_s).requires_grad_()
    got = tc.sparse_project(St, rt, torch.from_numpy(S_idx), tr)
    got.sin().sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(_project_ref(
        jnp.asarray(S), jnp.asarray(r_s), jnp.asarray(S_idx))), rtol=1e-5,
        atol=1e-5)
    np.testing.assert_allclose(St.grad.numpy(), np.asarray(want_dS),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rt.grad.numpy(), np.asarray(want_drs),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('rows,block_entries', BLOCKINGS)
@pytest.mark.parametrize('hub', [False, True])
def test_sparse_gather_values_and_gradients_match_jax(rows, block_entries,
                                                      hub):
    S_idx, _, _, feat = _case(4, hub=hub)
    jr, tr = _routes(S_idx, rows=rows, block_entries=block_entries)
    w = np.random.RandomState(9).randn(*S_idx.shape, feat.shape[-1]).astype(
        np.float32)
    want, vjp = jax.vjp(lambda f: jc.sparse_gather(f, jnp.asarray(S_idx),
                                                   jr), jnp.asarray(feat))
    want_g, = vjp(jnp.asarray(w))
    ft = torch.from_numpy(feat).requires_grad_()
    got = tc.sparse_gather(ft, torch.from_numpy(S_idx), tr)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(want_g),
                               rtol=1e-5, atol=1e-5)
    assert ft.grad.dtype == torch.float32


def test_gather_gradient_is_cast_once_to_the_inputs_dtype():
    """bf16 rows: the cotangent's routed sum in float32, then one cast."""
    S_idx, _, _, feat = _case(6)
    _, tr = _routes(S_idx, rows=8, block_entries=16)
    ft = torch.from_numpy(feat).to(torch.bfloat16).requires_grad_()
    w = torch.randn(*S_idx.shape, feat.shape[-1],
                    generator=torch.Generator().manual_seed(0))
    out = tc.sparse_gather(ft, torch.from_numpy(S_idx), tr)
    (out.float() * w).sum().backward()
    want = tr.plain_sum(w.to(torch.bfloat16).reshape(2, -1, 7), 'ent')
    assert ft.grad.dtype == torch.bfloat16
    assert torch.equal(ft.grad, want.to(torch.bfloat16))


@pytest.mark.parametrize('rows,block_entries', BLOCKINGS)
@pytest.mark.parametrize('which', ['src', 'ent'])
def test_scaled_ordered_aggregate_matches_scaled_plain(rows, block_entries,
                                                       which):
    S_idx, S, r_s, _ = _case(7, hub=True, padded=True)
    _, tr = _routes(S_idx, rows=rows, block_entries=block_entries)
    B, N_s, K = S_idx.shape
    gen = np.random.RandomState(8)
    M = N_s if which == 'src' else N_s * K
    ints = gen.randint(-4, 5, (B, M, 7)).astype(np.float32)
    quarters = (gen.randint(-8, 9, S.shape) / 4).astype(np.float32)
    scaled = which == 'src'
    for x, s, exact in ((ints, quarters, True), (
            gen.randn(B, M, 7).astype(np.float32), S, False)):
        x = torch.from_numpy(x)
        s = torch.from_numpy(s)
        table = tr.table(which)
        got = tb.ordered_aggregate(x, table,
                                   tr.row_scale(s) if scaled else None)
        plain = tb.plain_aggregate(x, table,
                                   tr.block_scale(s) if scaled else None)
        assert got.shape == plain.shape == (B, N_T, 7)
        if exact:
            assert torch.equal(got, plain)
        else:
            torch.testing.assert_close(got, plain, rtol=1e-5,
                                       atol=1e-5 * float(plain.abs().max()))


def test_scaled_ordered_aggregate_bf16_rows_round_as_the_rows_dtype():
    """bf16 rows of 64 channels (128 bytes: read as bf16): the scale and
    each product rounded to bf16, as JAX's ``g * scale.astype(g.dtype)``;
    bit-equal to the plain version where every sum is exact, and not the
    float32 product's sum on random values."""
    S_idx, S, _, _ = _case(10, N_s=30, K=4)
    _, tr = _routes(S_idx, rows=8, block_entries=16)
    gen = np.random.RandomState(11)
    x = torch.from_numpy(gen.randint(-4, 5, (2, 30, 64)).astype(
        np.float32)).to(torch.bfloat16)
    q = torch.from_numpy((gen.randint(-8, 9, S.shape) / 4).astype(
        np.float32))
    table = tr.table('src')
    got = tb.ordered_aggregate(x, table, tr.row_scale(q, torch.bfloat16))
    assert torch.equal(got, tb.plain_aggregate(x, table, tr.block_scale(q)))
    s = torch.from_numpy(S) / 3
    bf = tb.ordered_aggregate(x, table, tr.row_scale(s, torch.bfloat16))
    f32 = tb.ordered_aggregate(x.float(), table, tr.row_scale(s))
    assert not torch.equal(bf, f32)
    torch.testing.assert_close(
        bf, tb.plain_aggregate(x, table, tr.block_scale(s)), rtol=2e-2,
        atol=2e-2 * float(f32.abs().max()))


def test_cpu_wrappers_take_the_plain_version_and_record_it():
    S_idx, S, r_s, _ = _case(12)
    _, tr = _routes(S_idx, rows=16, block_entries=64)
    dispatch.reset()
    S_t, r_t = torch.from_numpy(S), torch.from_numpy(r_s)
    out = kb.route_project(r_t, S_t, tr)
    g = torch.randn(2, 37 * 5, 7, generator=torch.Generator().manual_seed(1))
    back = kb.route_gather_bwd(g, tr)
    d = dispatch.decisions()
    for name in ('corr_project', 'corr_gather_bwd'):
        assert (d[name]['path'], d[name]['reason']) == ('plain',
                                                        'device=cpu')
        assert dispatch.launch_counts()[name] == 0
    assert torch.equal(out, tr.plain_sum(r_t, 'src', tr.block_scale(S_t)))
    assert torch.equal(back, tr.plain_sum(g, 'ent'))
    with pytest.raises(ValueError, match='table'):
        kb.route_project(r_t[0], S_t, tr)


def test_route_work_counts_the_compulsory_traffic():
    """The work functions the cost account and the card's bounds read:
    at the phase-2 training shape (N_s = 15000, K = 20, n_t = 20000,
    C = 32) the scaled projection moves about 6.9 MB and the gather's
    backward about 42 MB."""
    proj = kb.route_work('corr_project', 1, 15000, 20000, 300000, 32, 4,
                         True)
    back = kb.route_work('corr_gather_bwd', 1, 300000, 20000, 300000, 32, 4,
                         False)
    assert proj['flops'] == 2 * 300000 * 32 and back['flops'] == 300000 * 32
    assert proj['bytes'] == (15000 + 20000) * 32 * 4 + 8 * 300000
    assert back['bytes'] == (300000 + 20000) * 32 * 4 + 4 * 300000
    assert proj['out_bytes'] == back['out_bytes'] == 20000 * 32 * 4


def test_route_builds_on_the_device_without_reading_it():
    """The route is pure tensor work: built under a mode that refuses a
    read of a tensor's values on the host (``.item()``, ``.tolist()``),
    as a captured step would."""
    S_idx, *_ = _case(13)
    idx = torch.from_numpy(S_idx)

    class NoHostReads(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            if func in (torch.Tensor.item, torch.Tensor.tolist,
                        torch.Tensor.__bool__, torch.Tensor.numpy):
                raise AssertionError(f'{func} read a tensor on the host')
            return func(*args, **(kwargs or {}))

    with NoHostReads():
        route = tc.build_corr_route(idx, N_T, rows=8, block_entries=16)
    _, want = _routes(S_idx, rows=8, block_entries=16)
    for a, b in zip(route.tensors(), want.tensors()):
        assert torch.equal(a, b)
