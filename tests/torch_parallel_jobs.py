"""What each rank runs in the port's parallel tests
(:func:`tests.torch_dist_worker.run_ranks`). Imports torch and the port
only: the ranks never load JAX."""

import numpy as np
import torch

from dgmc_tpu_torch.parallel import (corr_sharded_topk, make_mesh,
                                     sharded_topk_cols, sharded_topk_rows)
from dgmc_tpu_torch.parallel.comm import all_gather
from dgmc_tpu_torch.parallel.distributed import process_count
from dgmc_tpu_torch.parallel.mesh import NamedSharding


def _t(x):
    return None if x is None else torch.as_tensor(x)


def topk_cases(cases):
    """``{name: indices}`` of each case ``(kind, h_s, h_t, t_mask, k,
    kw)``, whole on every rank: ``rows`` and ``cols`` over a ``1 x n``
    mesh's model axis, ``corr`` / ``ring`` through
    :func:`corr_sharded_topk` with the rows over the data axis of an
    ``n x 1`` mesh (each rank's block gathered and cut to ``N_s``),
    ``corr_batch`` with the batch over ``data`` of a ``2 x n/2`` mesh
    (``None`` where it declines), and ``cols_refuse`` the error's
    text."""
    n = process_count()
    by_model = make_mesh(data=1, model=n, device='cpu')
    by_data = make_mesh(data=n, model=1, device='cpu')
    split = make_mesh(data=2, model=n // 2, device='cpu') if n % 2 == 0 \
        else None
    out = {}
    for name, (kind, h_s, h_t, t_mask, k, kw) in cases.items():
        h_s, h_t, t_mask = _t(h_s), _t(h_t), _t(t_mask)
        if kind == 'rows':
            got = sharded_topk_rows(by_model, h_s, h_t, k, t_mask,
                                    gather=True, **kw)
        elif kind == 'cols':
            got = sharded_topk_cols(by_model, h_s, h_t, k, t_mask, **kw)
        elif kind == 'cols_refuse':
            try:
                sharded_topk_cols(by_model, h_s, h_t, k, t_mask, **kw)
                got = None
            except ValueError as e:
                got = str(e)
        elif kind == 'corr_batch':
            got = corr_sharded_topk(
                NamedSharding(split, ('data', 'model')), h_s, h_t, k,
                t_mask, **kw)
            got = None if got is None else got.shape
        else:
            sh = NamedSharding(by_data, (None, 'data'))
            block = corr_sharded_topk(sh, h_s, h_t, k, t_mask,
                                      ring=kind == 'ring', **kw)
            got = all_gather(block, by_data.group('data'),
                             dim=1)[:, :h_s.shape[1]]
        out[name] = got.numpy() if torch.is_tensor(got) else got
    return out


def _kg(argv):
    from dgmc_tpu_torch.experiments import dbp15k
    args = dbp15k.parse_args(['--synthetic', '--device', 'cpu', *argv])
    train, test, in_dim = dbp15k.load_batches(args)
    return args, dbp15k.build(args, in_dim), train, test


def kg_schedule(argv, rules_kw=None, schedule=(('phase1', 2), ('phase2', 2)),
                jit=True):
    """A tiny KG model's train steps and evaluations, one process
    (``rules_kw`` ``None``) or row-sharded over every rank through
    :func:`~dgmc_tpu_torch.parallel.rules.streamed_rules` (``rules_kw``
    its arguments): ``(train metrics, eval metrics, parameters)``."""
    from dgmc_tpu_torch.experiments.dbp15k import noise_seed
    from dgmc_tpu_torch.parallel import (make_sharded_eval_step,
                                         make_sharded_train_step,
                                         streamed_rules)
    from dgmc_tpu_torch.train.state import create_train_state
    from dgmc_tpu_torch.train.steps import (batch_to_device, make_eval_step,
                                            make_train_step)
    args, model, train, test = _kg(argv)
    state = create_train_state(model, learning_rate=args.lr)
    if rules_kw is None:
        steps = {'phase1': make_train_step(model, num_steps=0, jit=jit),
                 'phase2': make_train_step(model, num_steps=args.num_steps,
                                           detach=True, jit=jit),
                 'eval': make_eval_step(model, hits_ks=(10,),
                                        num_steps=args.num_steps, jit=jit)}
        train, test = (batch_to_device(b, 'cpu') for b in (train, test))
    else:
        mesh = make_mesh(data=process_count(), model=1, device='cpu')
        rules = streamed_rules(**rules_kw)
        steps = {'phase1': make_sharded_train_step(
                     model, mesh, num_steps=0, rules=rules, jit=jit),
                 'phase2': make_sharded_train_step(
                     model, mesh, num_steps=args.num_steps, detach=True,
                     rules=rules, jit=jit),
                 'eval': make_sharded_eval_step(
                     model, mesh, hits_ks=(10,), num_steps=args.num_steps,
                     rules=rules, jit=jit)}
        state, train = rules.place(state, train, mesh, model)
        test = rules.place(state, test, mesh, model)[1]
    outs, evals = [], []
    epoch = 0
    for name, n in schedule:
        for _ in range(n):
            epoch += 1
            state, out = steps[name](state, train,
                                     noise_seed(args.seed, 0, epoch))
            outs.append({k: v.clone().numpy() for k, v in out.items()})
        evals.append({k: v.clone().numpy() for k, v in steps['eval'](
            test, noise_seed(args.seed, 1, epoch)).items()})
    params = {k: v.detach().clone().numpy()
              for k, v in model.state_dict().items()}
    return outs, evals, params


def build_model(spec):
    """The port's model of a test case: ``('spline', k, num_steps)``,
    JAX's ``tests/train/test_steps.tiny_model`` (``('spline', k,
    num_steps, p)``: with dropout ``p`` after ψ₁, as ``pascal``'s);
    ``('rel', k, num_steps, batch_norm, p)``, a two-layer RelCNN ψ₁ 4 → 8
    (DBP15K's, narrow) with a one-layer RelCNN ψ₂; ``('gin', k,
    num_steps)``, a GIN ψ₁ with batch norm and the same ψ₂;
    ``('bn_rel',)``, the batch-norm model of JAX's
    ``tests/parallel/test_batchnorm_dp.py``."""
    from dgmc_tpu_torch.models.dgmc import DGMC
    from dgmc_tpu_torch.models.gin import GIN
    from dgmc_tpu_torch.models.rel import RelCNN
    from dgmc_tpu_torch.models.spline import SplineCNN
    if spec[0] == 'rel':
        _, k, num_steps, bn, p = spec
        return DGMC(RelCNN(4, 8, 2, batch_norm=bn, dropout=p),
                    RelCNN(4, 4, 1), num_steps=num_steps, k=k)
    if spec[0] == 'gin':
        _, k, num_steps = spec
        return DGMC(GIN(4, 8, 2, batch_norm=True), RelCNN(4, 4, 1),
                    num_steps=num_steps, k=k)
    if spec[0] == 'spline':
        _, k, num_steps, *p = spec
        return DGMC(SplineCNN(1, 16, 2, 2, cat=False, lin=True,
                              dropout=p[0] if p else 0.0),
                    SplineCNN(8, 8, 2, 2, cat=True, lin=True),
                    num_steps=num_steps, k=k)
    return DGMC(RelCNN(4, 6, 1, batch_norm=True), RelCNN(4, 4, 1),
                num_steps=1, k=-1)


def sgd_state(model, lr):
    from dgmc_tpu_torch.train.state import TrainState
    return TrainState(optimizer=torch.optim.SGD(model.parameters(), lr=lr))


def one_step(case, sharded):
    """One SGD train step of ``case`` (and, for a streamed case, one eval
    step), the draws injected: one process (``sharded`` false) or over
    every rank, as the case's layout says. Returns the metrics, the
    parameters and buffers after the step and the eval sums."""
    from dgmc_tpu_torch.parallel import (make_sharded_eval_step,
                                         make_sharded_train_step,
                                         shard_batch, streamed_rules)
    from dgmc_tpu_torch.parallel.distributed import cut
    from dgmc_tpu_torch.train.steps import make_eval_step, make_train_step
    model = build_model(case['model'])
    model.load_state_dict({k: torch.as_tensor(v)
                           for k, v in case['state_dict'].items()})
    state = sgd_state(model, case['lr'])
    r_s, neg = _t(case['r_s']), _t(case.get('negatives'))
    ev_r_s = _t(case.get('eval_r_s'))
    layout = case['layout']
    n = process_count()
    evals = None
    if not sharded:
        step = make_train_step(model, loss_on_s0=case['loss_on_s0'])
        state, out = step(state, case['batch'], 0, r_s=r_s, negatives=neg)
        if layout == 'rows':
            evals = make_eval_step(model, hits_ks=(1,))(case['batch'], 0,
                                                        r_s=ev_r_s)
    else:
        rules = None
        if layout == 'data':
            mesh = make_mesh(data=n, model=1, device='cpu')
            axis = 'data'
            me = mesh.axis_index('data')
            if r_s is not None:
                r_s = cut(r_s.transpose(0, 1), n, me).transpose(0, 1)
            neg = None if neg is None else cut(neg, n, me)
        elif layout == 'corr':
            from dgmc_tpu_torch.parallel import corr_sharding
            mesh = make_mesh(data=1, model=n, device='cpu')
            axis = None
            model = model.with_layout(corr_sharding=corr_sharding(mesh))
        else:
            mesh = make_mesh(data=n, model=1, device='cpu')
            rules = streamed_rules(stream_chunk=case['chunk'])
            axis = None
        step = make_sharded_train_step(model, mesh,
                                       loss_on_s0=case['loss_on_s0'],
                                       batch_axis=axis, rules=rules)
        state, out = step(state, shard_batch(case['batch'], mesh, axis), 0,
                          r_s=r_s, negatives=neg)
        if layout == 'rows':
            evals = make_sharded_eval_step(
                model, mesh, hits_ks=(1,), batch_axis=axis, rules=rules)(
                shard_batch(case['batch'], mesh, axis), 0, r_s=ev_r_s)
    return {'metrics': {k: v.clone().numpy() for k, v in out.items()},
            'state': {k: v.detach().clone().numpy()
                      for k, v in model.state_dict().items()},
            'evals': None if evals is None else {
                k: v.clone().numpy() for k, v in evals.items()}}


def step_cases(cases):
    """:func:`one_step` of each case over every rank."""
    return {name: one_step(case, True) for name, case in cases.items()}


def port_case(name, layout, k, batch_size):
    """A case of :func:`one_step` from the port alone: JAX's tiny model
    and loader (``tests/train/test_steps.py``) built by the port, its own
    initial weights and its own random draws (each pair's Philox stream:
    a rank draws what its pairs draw in one process; a name ending in
    ``-drop`` puts dropout 0.5 after ψ₁, whose masks a rank cuts from the
    whole batch's)."""
    from dgmc_tpu_torch.data.synthetic import RandomGraphPairs
    from dgmc_tpu_torch.data.transforms import (Cartesian, Compose,
                                                Constant, KNNGraph)
    from dgmc_tpu_torch.utils.data import PairLoader
    spec = (('bn_rel',) if name == 'bn' else
            ('spline', k, 2) + ((0.5,) if name.endswith('-drop') else ()))
    model = build_model(spec)
    model.reset_parameters(torch.Generator().manual_seed(0))
    if name == 'bn':
        batch = bn_batch()
    else:
        ds = RandomGraphPairs(6, 10, 0, 2, transform=Compose(
            [Constant(), KNNGraph(k=4), Cartesian()]), length=8, seed=0)
        batch = next(iter(PairLoader(ds, batch_size, shuffle=True, seed=0,
                                     num_nodes=12, num_edges=48)))
    return {'model': spec, 'lr': 1e-2,
            'state_dict': {key: v.numpy()
                           for key, v in model.state_dict().items()},
            'batch': batch, 'r_s': None, 'negatives': None,
            'loss_on_s0': layout == 'data', 'layout': layout, 'chunk': 4}


def bn_batch(B=8, n=8, e=20, c=4):
    """JAX's batch-norm case (``tests/parallel/test_batchnorm_dp.py``'s
    ``_batch``: B = 8 random graphs of 8 nodes and 20 edges, 4 features,
    some nodes padding) as the port's host batch, the padding at each
    graph's tail as both packages' collation lays it out."""
    from dgmc_tpu_torch.utils.data import PairBatch
    r = np.random.RandomState(0)

    def side(seed):
        rr = np.random.RandomState(seed)
        count = rr.randint(n // 2, n + 1, B)
        mask = np.arange(n)[None] < count[:, None]
        ends = [(rr.randint(0, 1 << 20, (B, e)) % count[:, None]).astype(
            np.int32) for _ in range(2)]
        return {'x': rr.randn(B, n, c).astype(np.float32) * mask[..., None],
                'senders': ends[0], 'receivers': ends[1], 'node_mask': mask,
                'edge_mask': np.ones((B, e), bool)}

    y = np.stack([r.permutation(n) for _ in range(B)]).astype(np.int32)
    return PairBatch(s=side(1), t=side(2), y=y, y_mask=y >= 0)


def checkpoint_job(directory):
    """Two saves and a resume under the coordinator rule, from every
    rank: ``(commits, restored start epoch, restored parameters, the
    step files)``. Rank 0 changes its weights before saving; the others
    restore rank 0's."""
    from dgmc_tpu_torch.parallel.distributed import process_index
    from dgmc_tpu_torch.train.checkpoint import Checkpointer, resume_or_init
    from dgmc_tpu_torch.train.state import create_train_state
    model = build_model(('spline', 4, 2))
    state = create_train_state(model)
    ckpt = Checkpointer(directory)
    for step in (1, 2):
        with torch.no_grad():
            for p in model.parameters():
                p.fill_(step * 10 + (process_index() == 0))
        ckpt.save(step, model, state)
    commits = [c['step'] for c in ckpt.take_commits()]
    ckpt.close()
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    mesh = make_mesh(device='cpu')
    _, state, start = resume_or_init(directory, state, model, mesh=mesh)
    import os
    return (commits, start,
            {k: v.clone().numpy() for k, v in model.state_dict().items()},
            sorted(os.listdir(directory)))


def mesh_specimens(inject):
    """Every registered mesh specimen on the world's ranks, built with
    ``inject``'s weights and draws (JAX's), each rank's records gathered
    to every rank as a process in a world of enough ranks gathers them:
    ``{name: [records, rank order]}`` (``analysis/ranks.py``)."""
    from dgmc_tpu_torch.analysis.ranks import gather_in_world
    return gather_in_world('cpu', inject=inject)


def _rank_tensors(rank, shape=(2, 3, 5)):
    """The tensors rank ``rank`` sends in the collective tests: float32,
    bfloat16, int32 and bool, from a seed of its own."""
    g = torch.Generator().manual_seed(100 + rank)
    x = torch.randn(shape, generator=g)
    return {'float32': x, 'bfloat16': (x * 3).to(torch.bfloat16),
            'int32': torch.randint(-1 << 30, 1 << 30, shape, generator=g,
                                   dtype=torch.int32),
            'bool': torch.rand(shape, generator=g) < 0.5}


def comm_job():
    """:mod:`~dgmc_tpu_torch.parallel.comm`'s permute and differentiable
    all-gather on the world's ranks: what each rank received (each dtype
    alone, then all four in one call whose handle is waited on after an
    all-reduce), the gradient of its block through
    :func:`~dgmc_tpu_torch.parallel.comm.all_gather_grad`, and the tape
    of one permute and one gathered backward (op kinds, collective kinds,
    payloads)."""
    from dgmc_tpu_torch.analysis.trace_rules import TapeRecorder
    from dgmc_tpu_torch.ops.kernels import dispatch
    from dgmc_tpu_torch.parallel.comm import (all_gather_grad, all_reduce_,
                                              collective_permute)
    from dgmc_tpu_torch.parallel.distributed import process_index
    me = process_index()
    group = make_mesh(data=process_count(), model=1, device='cpu').group()
    mine = _rank_tensors(me)
    out = {'single': {k: collective_permute(v, group).wait().numpy()
                      if k != 'bfloat16' else
                      collective_permute(v, group).wait().view(
                          torch.int16).numpy()
                      for k, v in mine.items()}}
    dispatch.reset()
    handle = collective_permute(tuple(mine.values()), group)
    total = all_reduce_(torch.ones(4), group)       # other work meanwhile
    got = handle.wait()
    out['after_other_work'] = float(total[0])
    out['tuple'] = [t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
                    else t.numpy() for t in got]
    out['route'] = dispatch.decisions()['collective']['reason']
    g = torch.Generator().manual_seed(7 + me)
    x = torch.randn(2, 3, 4, generator=g, requires_grad=True)
    w = torch.randn(2, 3 * process_count(), 4, generator=g)
    (all_gather_grad(x, group, dim=1) * w).sum().backward()
    out['grad'], out['w'] = x.grad.numpy(), w.numpy()
    x2 = torch.randn(2, 3, 4, generator=g, requires_grad=True)
    with TapeRecorder() as rec:
        h = collective_permute((mine['float32'], mine['bool']), group)
        y = (x2 * 2).sum()
        h.wait()
        all_gather_grad(x2, group, dim=1).sum().backward()
    out['tape'] = [(op.kind, (op.collective or {}).get('kind'),
                    (op.collective or {}).get('payload'),
                    (op.collective or {}).get('async'),
                    (op.collective or {}).get('start'))
                   for op in rec.tape.ops
                   if op.kind in ('collective', 'wait')]
    del y
    return out


#: The ψ₁ table cases' blocked adjacency: ranges of 8 rows (a rank's
#: block of 10 or 12 rows straddles them), blocks of 16 edges.
REL_BLOCKS = {'rows': 8, 'block_edges': 16, 'min_nodes': 1}


def rel_arrays(n_s=20, e_s=60, n_t=24, e_t=72, c=4, seed=0):
    """One random pair for the ψ₁ table cases (B = 1; ``n_s`` / ``n_t``
    nodes, the last two of each padding; ``e_s`` / ``e_t`` edges, the
    last four padding; ``c`` features): ``{'s', 't', 'y', 'y_mask'}`` of
    numpy arrays, the truth a permutation into the target's real
    nodes."""
    r = np.random.RandomState(seed)

    def side(n, e):
        real = n - 2
        mask = np.arange(n)[None] < real
        ends = r.randint(0, real, (2, 1, e)).astype(np.int32)
        emask = np.arange(e)[None] < e - 4
        return {'x': (r.randn(1, n, c) * mask[..., None]).astype(np.float32),
                'senders': ends[0] * emask, 'receivers': ends[1] * emask,
                'node_mask': mask, 'edge_mask': emask}

    s, t = side(n_s, e_s), side(n_t, e_t)
    y = r.permutation(n_t - 2)[:n_s][None].astype(np.int32)
    y_mask = np.arange(n_s)[None] < n_s - 2
    return {'s': s, 't': t, 'y': np.where(y_mask, y, 0), 'y_mask': y_mask}


def rel_batch(arrays=None):
    """:func:`rel_arrays` as the port's host batch, blocked
    (:data:`REL_BLOCKS`)."""
    from dgmc_tpu_torch.ops.blocked import attach_blocks
    from dgmc_tpu_torch.utils.data import PairBatch
    a = rel_arrays() if arrays is None else arrays
    return PairBatch(s=attach_blocks(dict(a['s']), **REL_BLOCKS),
                     t=attach_blocks(dict(a['t']), **REL_BLOCKS), y=a['y'],
                     y_mask=a['y_mask'])


def table_case(name, spec, phases, seed=0):
    """A ψ₁ table case from the port alone: ``spec`` (:func:`build_model`)
    with its own initial weights and draws on :func:`rel_batch`; each of
    ``phases`` (``(name, num_steps, detach)``) one SGD step from the same
    state."""
    model = build_model(spec)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return {'model': spec, 'lr': 1e-2, 'batch': rel_batch(),
            'state_dict': {k: v.numpy()
                           for k, v in model.state_dict().items()},
            'r_s': None, 'negatives': None, 'loss_on_s0': False,
            'chunk': 4, 'phases': tuple(phases)}


def _table_rules(chunk, tables):
    """``streamed_rules`` (the replicated ψ₁ tables), with ``tables`` its
    ``'psi1'`` / ``'corpus'`` rules added as a caller opts in."""
    import dataclasses
    from dgmc_tpu_torch.parallel import streamed_rules
    rules = streamed_rules(stream_chunk=chunk)
    if tables:
        row = rules.activations['corr']
        rules = dataclasses.replace(rules, activations=dict(
            rules.activations, psi1=row, corpus=row))
    return rules


def table_steps(cases):
    """Each ψ₁ table case on the world's ranks, under the replicated
    tables (``'replicated'``) and the sharded ones (``'tables'``): per
    phase the metrics and the state after one step; the shortlist of a
    training forward (the rank's rows gathered); the dispatch ledger's
    ``psi1_rows``; with the sharded tables the ψ₁ tables' shapes a rank
    held (ψ₁'s outputs) and the tape of the last phase's step with its
    collectives (kind, payload) in order."""
    from dgmc_tpu_torch.analysis.trace_rules import TapeRecorder
    from dgmc_tpu_torch.models import dgmc as dgmc_mod
    from dgmc_tpu_torch.ops.kernels import dispatch
    from dgmc_tpu_torch.parallel import make_sharded_train_step, shard_batch
    from dgmc_tpu_torch.train.steps import batch_to_device, dropout_generator
    n = process_count()
    mesh = make_mesh(data=n, model=1, device='cpu')
    held = []
    psi1 = dgmc_mod.DGMC._psi1

    def spy(self, x, graph, generator, rows):
        out = psi1(self, x, graph, generator, rows)
        held.append(tuple(out.shape))
        return out
    out = {}
    for name, case in cases.items():
        r_s, neg = _t(case['r_s']), _t(case.get('negatives'))
        got = {}
        for tables in (False, True):
            rules = _table_rules(case['chunk'], tables)
            res = {'steps': {}}
            for phase, num_steps, detach in case['phases']:
                model = build_model(case['model'])
                model.load_state_dict({k: torch.as_tensor(v) for k, v in
                                       case['state_dict'].items()})
                state = sgd_state(model, case['lr'])
                step = make_sharded_train_step(
                    model, mesh, num_steps=num_steps, detach=detach,
                    batch_axis=None, rules=rules,
                    loss_on_s0=case['loss_on_s0'])
                batch = shard_batch(case['batch'], mesh, None)
                kw = {'r_s': None if num_steps == 0 or r_s is None
                      else r_s[:num_steps], 'negatives': neg}
                dispatch.reset()
                held.clear()
                dgmc_mod.DGMC._psi1 = spy
                try:
                    if tables and phase == case['phases'][-1][0]:
                        with TapeRecorder() as rec:
                            state, m = step(state, batch, 0, **kw)
                        res['tape'] = rec.tape
                        res['collectives'] = [
                            (op.collective['kind'], op.collective['payload'])
                            for op in rec.tape.ops
                            if op.kind == 'collective']
                    else:
                        state, m = step(state, batch, 0, **kw)
                finally:
                    dgmc_mod.DGMC._psi1 = psi1
                res['steps'][phase] = {
                    'metrics': {k: v.clone().numpy() for k, v in m.items()},
                    'state': {k: v.detach().clone().numpy()
                              for k, v in model.state_dict().items()}}
                res['held'] = list(held)
                res['psi1_rows'] = dispatch.decisions().get('psi1_rows')
            # A training forward's shortlist from the initial weights.
            model = build_model(case['model'])
            model.load_state_dict({k: torch.as_tensor(v) for k, v in
                                   case['state_dict'].items()})
            laid = rules.apply_to_model(model, mesh)
            db = batch_to_device(case['batch'], 'cpu')
            T = case['phases'][-1][1]
            S_0, _ = laid.train()(
                db.graph_s, db.graph_t, y=db.y, y_mask=db.y_mask,
                num_steps=T, r_s=None if r_s is None else r_s[:T],
                negatives=neg, generator=dropout_generator(0, 'cpu'))
            res['shortlist'] = all_gather(
                S_0.idx.contiguous(), mesh.group(),
                dim=1)[:, :db.y.shape[1]].numpy()
            got['tables' if tables else 'replicated'] = res
        out[name] = got
    return out


def table_account(argv):
    """The collective account (``efficiency.json``'s ``programs``, as
    :func:`~dgmc_tpu_torch.obs.cost.efficiency_payload` writes it) of a
    tiny KG model's phase-1 and phase-2 steps row-sharded over every rank
    with the sharded ψ₁ tables (``streamed_rules`` plus ``'psi1'`` /
    ``'corpus'``), and ψ₁'s layer count."""
    from dgmc_tpu_torch.obs.cost import cost_summary, efficiency_payload
    from dgmc_tpu_torch.parallel import make_sharded_train_step
    from dgmc_tpu_torch.train.state import create_train_state
    args, model, train, _ = _kg(argv)
    state = create_train_state(model, learning_rate=args.lr)
    mesh = make_mesh(data=process_count(), model=1, device='cpu')
    rules = _table_rules(None, True)
    steps = {'phase1_step': make_sharded_train_step(
                 model, mesh, num_steps=0, rules=rules),
             'train_step': make_sharded_train_step(
                 model, mesh, num_steps=args.num_steps, detach=True,
                 rules=rules)}
    state, train = rules.place(state, train, mesh, model)
    programs = {name: cost_summary(step, state, train, 1)
                for name, step in steps.items()}
    return efficiency_payload(programs)['programs'], len(model.psi_1.convs)
