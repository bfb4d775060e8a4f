"""The port's trace (TRC) tier: a recorded run in the place of a jaxpr.

Each TRC001-006 case is a pair written line for line: a JAX function
with the hazard (the cases of ``tests/analysis/test_trace_rules.py``)
and its PyTorch counterpart, both in modules written to ``tmp_path``.
The JAX package's tier (``jaxpr_rules`` over ``jax.make_jaxpr``) and the
port's (``trace_rules`` over one recorded run) give the same rule, the
same severity and the same flagged line; JAX's TRC002 and TRC004 name
no line (a constant's shape, a donation), so those compare the rule,
the severity and the where. Also: the thresholds, a clean program, a
hazard in a submodule and in the autograd backward, TRC003's
provenance, the liveness bound on hand-made tapes, and the lint CLI's
trace-tier switches.
"""

import contextlib
import importlib.util
import io
import json
import os
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgmc_tpu_torch.analysis import lint as lint_mod
from dgmc_tpu_torch.analysis.liveness import module_peak, peak_summary
from dgmc_tpu_torch.analysis.trace_rules import (Buffer, Tape, TapeOp,
                                                 TapeRecorder, TraceContext,
                                                 analyze_tape, identities,
                                                 inplace_findings,
                                                 state_tensors)
from tests.torch_jax_worker import jax_analysis

#: No specimen tier: the trace tier and the mesh specimens' SHD and
#: SCH/MEM tiers.
NO_SPECIMENS = ('--skip-trace', '--skip-sharded', '--skip-sched')


@pytest.fixture(autouse=True, scope='module')
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _src(text):
    return textwrap.dedent(text).lstrip('\n')


def _load(tmp_path, name, text):
    path = tmp_path / f'{name}.py'
    path.write_text(text)
    spec = importlib.util.spec_from_file_location(name, str(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


#: (case, JAX module, port module, JAX args, port args, context kw,
#: port run's backward): the flagged line is the same line.
PAIRS = [
    ('TRC001', _src('''
        import jax.numpy as jnp
        import numpy as np


        def hazard(x):
            return x * np.float64(2.0)
        '''), _src('''
        import torch


        # one line for JAX's second import
        def hazard(x):
            return x.double() * 2.0
        '''), lambda: (jnp.ones((4,), jnp.float32),),
     lambda: (torch.ones(4),), {}, False),
    ('TRC002', _src('''
        import jax.numpy as jnp
        import numpy as np

        BIG_TABLE = jnp.asarray(np.ones((600, 600), np.float32))


        def hazard(x):
            return x @ BIG_TABLE
        '''), _src('''
        import torch


        BIG_TABLE = torch.ones((600, 600))


        def hazard(x):
            return x @ BIG_TABLE
        '''), lambda: (jnp.ones((600,)),), lambda: (torch.ones(600),), {},
     False),
    ('TRC003', _src('''
        import jax
        import jax.numpy as jnp


        def hazard(x):
            jax.debug.callback(lambda v: None, jnp.sum(x))
            return x * 2.0
        '''), _src('''
        import torch


        # one line for JAX's second import
        def hazard(x):
            scale = x.sum().item()
            return x * 2.0
        '''), lambda: (jnp.ones((8,)),), lambda: (torch.ones(8),), {},
     False),
    ('TRC005', _src('''
        import jax.numpy as jnp


        def hazard(x, idx, upd):
            return x.at[idx].add(upd)
        '''), _src('''
        import torch


        def hazard(x, idx, upd):
            return x.index_add(0, idx, upd)
        '''), lambda: (jnp.zeros((16,)), jnp.array([1, 2, 2]),
                       jnp.ones((3,))),
     lambda: (torch.zeros(16), torch.tensor([1, 2, 2]), torch.ones(3)), {},
     False),
    ('TRC006', _src('''
        import jax.numpy as jnp


        def hazard(x):
            return jnp.sort(x, axis=-1)[..., -8:]
        '''), _src('''
        import torch


        def hazard(x):
            return torch.sort(x, dim=-1)[0][..., -8:]
        '''), lambda: (jnp.ones((2, 8192)),), lambda: (torch.ones(2, 8192),),
     {'sort_dim': 4096}, False),
    ('TRC005-backward', _src('''
        import jax
        import jax.numpy as jnp


        def forward(x, idx):
            return jnp.sum(x[idx] * 3.0)


        hazard = jax.grad(forward)
        '''), _src('''
        import torch


        # one line for JAX's second import
        def forward(x, idx):
            return torch.sum(x[idx] * 3.0)


        def hazard(x, idx):
            forward(x, idx).backward()
        '''), lambda: (jnp.ones((6,)), jnp.array([0, 2, 2])),
     lambda: (torch.ones(6, requires_grad=True), torch.tensor([0, 2, 2])),
     {}, True),
]


def _jax_findings(mod, args, **ctx):
    with jax_analysis('dgmc_tpu.analysis.jaxpr_rules') as m:
        jr = m['jaxpr_rules']
        closed = jax.make_jaxpr(mod.hazard)(*args)
        return jr.analyze_closed_jaxpr(
            closed, jr.TraceContext(specimen='fixture', **ctx))


def _port_findings(mod, args, **ctx):
    with TapeRecorder(args) as rec:
        mod.hazard(*args)
    return analyze_tape(rec.tape, TraceContext(specimen='fixture', **ctx))


def _sites(findings):
    """``(rule, severity, line or where)`` of each finding."""
    out = []
    for f in findings:
        head, _, line = f.where.rpartition(':')
        loc = int(line) if line.isdigit() else f.where
        out.append((f.rule, f.severity.name, loc))
    return sorted(out, key=str)


@pytest.mark.parametrize('case,jax_src,port_src,jargs,pargs,ctx,bwd', PAIRS,
                         ids=[p[0] for p in PAIRS])
def test_rule_pair_flags_what_jax_flags(tmp_path, case, jax_src, port_src,
                                        jargs, pargs, ctx, bwd):
    jmod = _load(tmp_path, f'jax_{case.replace("-", "_")}', jax_src)
    pmod = _load(tmp_path, f'port_{case.replace("-", "_")}', port_src)
    if case == 'TRC001':
        with jax.enable_x64(True):
            want = _jax_findings(jmod, jargs(), **ctx)
    else:
        want = _jax_findings(jmod, jargs(), **ctx)
    got = _port_findings(pmod, pargs(), **ctx)
    rule = case.split('-')[0]
    assert [f.rule for f in want] == [rule], want
    assert _sites(got) == _sites(want), (got, want)
    if isinstance(_sites(got)[0][2], int):
        # Both point into their own fixture module.
        assert os.path.basename(got[0].where.split(':')[1]).startswith(
            'port_')


@pytest.mark.parametrize('case,jax_src,port_src,jargs,pargs,ctx', [
    ('TRC002', PAIRS[1][1], PAIRS[1][2], PAIRS[1][3], PAIRS[1][4],
     {'const_bytes': 16 << 20}),
    ('TRC006', PAIRS[4][1], PAIRS[4][2], lambda: (jnp.ones((2, 64)),),
     lambda: (torch.ones(2, 64),), {}),
], ids=['TRC002-threshold', 'TRC006-threshold'])
def test_thresholds_silence_both_tiers(tmp_path, case, jax_src, port_src,
                                       jargs, pargs, ctx):
    jmod = _load(tmp_path, f'jax_t_{case}', jax_src)
    pmod = _load(tmp_path, f'port_t_{case}', port_src)
    assert _jax_findings(jmod, jargs(), **ctx) == []
    assert _port_findings(pmod, pargs(), **ctx) == []


def test_dtype_drift_without_x64_is_clean_in_jax_but_not_in_torch(tmp_path):
    """JAX truncates the promotion with x64 off; torch has no such switch,
    so the port flags the same line whatever JAX's mode."""
    jmod = _load(tmp_path, 'jax_x32', PAIRS[0][1])
    pmod = _load(tmp_path, 'port_x32', PAIRS[0][2])
    assert _jax_findings(jmod, PAIRS[0][3]()) == []
    assert [f.rule for f in _port_findings(pmod, PAIRS[0][4]())] == \
        ['TRC001']


def test_int64_indices_are_no_drift():
    """int64 is torch's index dtype: sort / argsort / gather make it."""
    x = torch.randn(4, 6)
    with TapeRecorder((x,)) as rec:
        idx = torch.argsort(x, dim=-1)
        torch.gather(x, -1, idx[:, :2]).sum()
    assert analyze_tape(rec.tape) == []


def test_clean_program_produces_no_findings(tmp_path):
    jmod = _load(tmp_path, 'jax_clean', _src('''
        import jax.numpy as jnp


        def hazard(x, y):
            return jnp.tanh(x) @ y
        '''))
    pmod = _load(tmp_path, 'port_clean', _src('''
        import torch


        def hazard(x, y):
            return torch.tanh(x) @ y
        '''))
    assert _jax_findings(jmod, (jnp.ones((8, 8)), jnp.ones((8, 4)))) == []
    assert _port_findings(pmod, (torch.ones(8, 8), torch.ones(8, 4))) == []


def test_hazard_in_a_submodule_is_found_at_its_line(tmp_path):
    """JAX walks nested jaxprs (a callback in a scan body); the port's
    tape sees every op of a child module's forward."""
    jmod = _load(tmp_path, 'jax_nested', _src('''
        import jax
        import jax.numpy as jnp


        def hazard(x):
            def body(c, _):
                jax.debug.callback(lambda v: None, jnp.sum(c))
                return c * 2.0, None
            y, _ = jax.lax.scan(body, x, None, length=3)
            return y
        '''))
    pmod = _load(tmp_path, 'port_nested', _src('''
        import torch


        # one line for JAX's second import
        class Inner(torch.nn.Module):
            def forward(self, c):
                if bool(c.sum() > 0):
                    return c * 2.0
                return c


        def hazard(x):
            return Inner()(x)
        '''))
    want = _jax_findings(jmod, (jnp.ones((4,)),))
    got = _port_findings(pmod, (torch.ones(4),))
    assert [(f.rule, f.severity) for f in got] == \
        [(f.rule, f.severity) for f in want] == [('TRC003', want[0].severity)]
    assert _sites(got)[0][2] == _sites(want)[0][2]


def test_trc003_points_at_the_callers_line_not_into_torch(tmp_path):
    """``float(t)`` reads through torch's ``Tensor.__float__``; the
    finding names the port line that called it."""
    pmod = _load(tmp_path, 'port_float', _src('''
        import torch


        def scale_of(x):
            return float(x.abs().max())


        def hazard(x):
            return x / scale_of(x)
        '''))
    (f,) = _port_findings(pmod, (torch.randn(5),))
    assert f.rule == 'TRC003' and f.where.endswith('port_float.py:5')
    assert f.context == 'return float(x.abs().max())'


def test_backward_ops_take_the_forward_line_in_the_port_source():
    """A gather's backward (a scatter_add in the autograd engine) points
    at the forward's line in ``dgmc_tpu_torch``, not into torch."""
    from dgmc_tpu_torch.models import metrics
    from dgmc_tpu_torch.models.dgmc import Correspondence
    S = torch.randn(1, 3, 4, requires_grad=True)
    y = torch.tensor([[0, 2, 1]])
    mask = torch.ones(1, 3, dtype=torch.bool)
    corr = Correspondence(val=torch.softmax(S, -1), idx=None,
                          src_mask=mask, tgt_mask=torch.ones(1, 4,
                                                             dtype=torch.bool))
    with TapeRecorder((S,)) as rec:
        metrics.nll_loss(corr, y, mask).backward()
    found = analyze_tape(rec.tape)
    assert [f.rule for f in found] == ['TRC005']
    assert found[0].where.startswith('program:dgmc_tpu_torch/models/'
                                     'metrics.py:')
    assert 'torch.gather' in found[0].context
    assert any(op.backward for op in rec.tape.ops)


def test_trc004_inplace_update_is_clean_and_rebinding_fires():
    """JAX: a retained donation is clean and a dropped one fires; the
    port: an in-place update of the declared state is clean, a
    rebinding fires — same rule and severity."""
    with jax_analysis('dgmc_tpu.analysis.jaxpr_rules') as m:
        jr = m['jaxpr_rules']
        kept = jr.analyze_donation(lambda x: x * 2.0, (jnp.ones((64, 64)),),
                                   donate_argnums=(0,), specimen='fixture')
        dropped = jr.analyze_donation(jnp.sum, (jnp.ones((64, 64)),),
                                      donate_argnums=(0,),
                                      specimen='fixture')
    model = torch.nn.Linear(3, 2)
    before = identities(state_tensors(model))
    with torch.no_grad():
        model.weight.mul_(2.0)
    clean = inplace_findings(before, state_tensors(model), 'fixture')
    before = identities(state_tensors(model))
    model.weight.data = model.weight.detach() * 2.0
    model.bias = torch.nn.Parameter(model.bias.detach() + 1.0)
    fired = inplace_findings(before, state_tensors(model), 'fixture')
    assert kept == [] and clean == []
    assert {(f.rule, f.severity) for f in fired} == \
        {(f.rule, f.severity) for f in dropped} == \
        {('TRC004', dropped[0].severity)}
    assert sorted(f.where for f in fired) == [
        'fixture:inplace(0,):param:bias', 'fixture:inplace(0,):param:weight']


def test_kernel_marks_keep_their_inputs_alive():
    """A kernel entry's reads are out of the dispatcher's sight; its mark
    on the tape keeps them alive until it ran."""
    from dgmc_tpu_torch.obs.cost import WorkCounter
    from dgmc_tpu_torch.ops.kernels import topk
    h_s, h_t = torch.randn(1, 16, 8), torch.randn(1, 24, 8)
    rec = TapeRecorder((h_s, h_t))
    with WorkCounter(on_kernel=rec.mark), rec:
        topk.streaming_topk(h_s, h_t, 4)
    marks = [op for op in rec.tape.ops if op.kind == 'kernel']
    assert marks and all(op.reads for op in marks)


# ---------------------------------------------------------------------------
# Liveness on hand-made tapes
# ---------------------------------------------------------------------------


def _tape(args, ops, outputs):
    """``args``: {buffer: bytes} there before the run; ``ops``: (allocs
    {buffer: bytes}, reads) per op."""
    tape = Tape()
    for b, n in args.items():
        tape.buffers[b] = Buffer(nbytes=n, origin='argument')
    for i, (allocs, reads) in enumerate(ops):
        for b, n in allocs.items():
            tape.buffers[b] = Buffer(nbytes=n, origin='op', index=i,
                                     stage='psi1' if i < 2 else 'topk')
        tape.ops.append(TapeOp(index=i, name=f'op{i}',
                               allocs=tuple(allocs.items()),
                               reads=tuple(reads)))
    tape.outputs = set(outputs)
    return tape


@pytest.mark.parametrize('case,args,ops,outputs,peak,at', [
    # a -> b -> c -> d: each input dies after the op that reads it.
    ('chain', {0: 100}, [({1: 10}, [0]), ({2: 20}, [1]), ({3: 30}, [2])],
     [3], 100 + 20 + 30, 2),
    # b read by two ops, both outputs by a third.
    ('fan-out', {}, [({1: 50}, []), ({2: 10}, [1]), ({3: 10}, [1]),
                     ({4: 5}, [2, 3])], [4], 50 + 10 + 10, 2),
    # A view carries no bytes: reading it reads its base (buffer 1),
    # which stays live until the view's last read even though no op
    # names the base itself after op 0.
    ('view of a dead base', {}, [({1: 100}, []), ({}, [1]),
                                 ({2: 10}, [1]), ({3: 200}, [2])],
     [3], 10 + 200, 3),
])
def test_liveness_matches_the_peak_by_hand(case, args, ops, outputs, peak,
                                           at):
    tape = _tape(args, ops, outputs)
    lv = module_peak(tape)
    assert (lv.peak_bytes, lv.peak_index) == (peak, at)
    assert sum(b.nbytes for b in lv.live_at_peak) == peak
    summary = peak_summary(tape)
    assert summary['static_peak_bytes'] == peak
    assert sum(summary['peak_stage_bytes'].values()) == peak


def test_recorded_view_keeps_its_base_alive():
    x = torch.ones(1000)
    with TapeRecorder((x,)) as rec:
        base = x * 2.0
        view = base[:10]
        del base
        out = view + 1.0
    tape = rec.finish(out)
    mul, sl, add = tape.ops
    assert sl.allocs == () and sl.reads == (mul.allocs[0][0],)
    assert mul.allocs[0][0] in add.reads
    # x, the product and the sum live together at the sum.
    assert module_peak(tape).peak_bytes == 4000 + 4000 + 40


def test_liveness_summary_keys_are_jax_s():
    with jax_analysis('dgmc_tpu.analysis.hlo_liveness') as m:
        jl = m['hlo_liveness']
        want = set(jl.ComputationLiveness.__dataclass_fields__)
        jax_keys = {'static_peak_bytes', 'peak_stage_bytes'}
    tape = _tape({0: 8}, [({1: 4}, [0])], [1])
    assert set(peak_summary(tape)) == jax_keys
    assert want <= set(module_peak(tape).__dataclass_fields__) | {'name'}


# ---------------------------------------------------------------------------
# The lint CLI's trace tier
# ---------------------------------------------------------------------------


def _main(args):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = lint_mod.main(args)
    return rc, out.getvalue(), err.getvalue()


def test_skip_trace_runs_no_specimen(tmp_path):
    rc, out, err = _main(['--json', *NO_SPECIMENS, '--skip-source',
                          '--fail-on', 'none', '--baseline',
                          str(tmp_path / 'none.json')])
    assert rc == 0 and 'trace ' not in err
    assert not [f for f in json.loads(out)['findings']
                if f['rule'].startswith('TRC')]


def test_select_trc003_runs_the_trace_tier_alone(tmp_path):
    rc, out, err = _main(['--select', 'TRC003', '--device', 'cpu',
                          '--fail-on', 'any', '--baseline',
                          str(tmp_path / 'none.json')])
    assert rc == 0, out
    assert 'source tier' not in err and 'concurrency tier' not in err
    assert 'trace forward_dense on cpu' in err


def test_cli_imports_no_torch_without_the_trace_tier():
    import subprocess
    code = ('import sys; from dgmc_tpu_torch.analysis import lint; '
            'rc = lint.main(["--skip-trace", "--skip-sharded", '
            '"--skip-sched", "--skip-source", '
            '"--skip-concurrency", "--fail-on", "none"]); '
            'print("torch" in sys.modules)')
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, '-c', code], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip().endswith('False'), r


def test_baseline_keeps_trace_entries_when_the_tier_is_skipped(tmp_path):
    path = str(tmp_path / 'baseline.json')
    rc, _, _ = _main(['--select', 'TRC001,TRC005', '--device', 'cpu',
                      '--write-baseline', '--baseline', path])
    with open(path) as f:
        traced = json.load(f)['findings']
    assert rc == 0 and {e['rule'] for e in traced} == {'TRC001', 'TRC005'}
    for flag in ('--write-baseline', '--prune-baseline'):
        rc, _, _ = _main([*NO_SPECIMENS, '--skip-source', flag,
                          '--baseline', path])
        with open(path) as f:
            kept = json.load(f)['findings']
        assert rc == 0
        assert {e['fingerprint'] for e in traced} <= \
            {e['fingerprint'] for e in kept}, flag
    rc, out, _ = _main(['--select', 'TRC001,TRC005', '--device', 'cpu',
                        '--json', '--baseline', path])
    assert rc == 0 and json.loads(out)['summary']['new'] == 0


def test_max_const_bytes_reaches_trc002(tmp_path, monkeypatch):
    """``--max-const-bytes`` is TRC002's threshold (JAX's flag)."""
    from dgmc_tpu_torch.analysis import registry
    seen = {}
    real = registry.run_trace_tier

    def spy(*a, **kw):
        seen.update(kw)
        return real(*a, **kw)
    monkeypatch.setattr(registry, 'run_trace_tier', spy)
    rc, _, _ = _main(['--select', 'TRC002', '--device', 'cpu',
                      '--max-const-bytes', '64', '--fail-on', 'none',
                      '--baseline', str(tmp_path / 'none.json')])
    assert rc == 0 and seen['const_bytes'] == 64
    np.testing.assert_equal(seen['cache'].device.type, 'cpu')
