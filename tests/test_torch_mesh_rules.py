"""The port's schedule model and its ten SHD / SCH / MEM rules held
against the JAX package's (``analysis/hlo_sched.py``,
``analysis/{shd,sched}_rules.py``), on the CPU, no ranks.

- **The schedule model.** Straight-line HLO computations, parsed by
  JAX's ``parse_hlo_module`` (pure text, no backend): the fixtures of
  ``tests/analysis/test_sched_rules.py`` (every computation of each) and
  the ENTRY of JAX's compiled ``parallel.sharded_topk_cols`` (two of the
  forced CPU devices). Each is converted into the port's tape ops (an op
  per instruction, a buffer per result, its operands read; JAX's free
  ops free; a collective its payload; a ``-done`` a wait on its
  ``-start``), and the port's ``overlap_fraction`` and
  ``critical_path_share`` must equal JAX's ``schedule_computation`` within
  1e-12 (the rounded summary's too).
- **The rules.** Each rule gets a crafted hazard tape and its clean
  twin; the verdict (rule, severity, fires or not) equals JAX's on the
  matching crafted HLO of ``tests/analysis/test_{shd,sched}_rules.py``.
  SHD301 runs on two crafted rank tapes (no test posts a collective on
  one rank only: that hangs gloo).
"""

import pytest

from dgmc_tpu_torch.analysis.comm import collective_table
from dgmc_tpu_torch.analysis.sched_rules import (SchedContext,
                                                 analyze_schedule_tape)
from dgmc_tpu_torch.analysis.schedule import schedule_summary, schedule_tape
from dgmc_tpu_torch.analysis.shd_rules import (ShardedContext,
                                               analyze_sharded_tape)
from dgmc_tpu_torch.analysis.trace_rules import Buffer, Tape, TapeOp
from tests.torch_jax_worker import jax_analysis


@pytest.fixture(scope='module')
def jax_side():
    """JAX's modules' results on their fixtures, computed in one block:
    ``{'comps': [(label, computation, JAX's schedule)], 'verdicts':
    {case: [(rule, severity)]}, 'free': FREE_OPS}``."""
    with jax_analysis('dgmc_tpu.analysis.hlo_comm',
                      'dgmc_tpu.analysis.hlo_sched',
                      'dgmc_tpu.analysis.shd_rules',
                      'dgmc_tpu.analysis.sched_rules',
                      'dgmc_tpu.analysis.registry') as m:
        from tests.analysis import test_sched_rules as ts
        from tests.analysis import test_shd_rules as td
        hc, hs = m['hlo_comm'], m['hlo_sched']
        texts = {name: getattr(ts, name) for name in (
            'SERIAL_ASYNC_LOOP', 'OVERLAPPED_ASYNC_LOOP', 'CHAINED_COMM',
            'SLACK_COMM', 'BIG_FETCH_LOOP', 'SMALL_FETCH_LOOP', 'BIG_PEAK',
            'RESIDUAL_LOOP', 'PIPELINED_ASYNC_LOOP',
            'TRIP_AMPLIFIED_LOOP')}
        reg = m['registry']
        (spec,) = [s for s in reg.default_specimens()
                   if s.name == 'parallel.sharded_topk_cols']
        compiled = reg.SpecimenCache().artifacts(spec).compiled().as_text()
        comps = []
        for label, text in texts.items():
            module = hc.parse_hlo_module(text)
            for name, comp in module.computations.items():
                comps.append((f'{label}/{name}', comp,
                              hs.schedule_computation(comp)))
        module = hc.parse_hlo_module(compiled)
        entry = module.computations[module.entry]
        comps.append(('sharded_topk_cols/ENTRY', entry,
                      hs.schedule_computation(entry)))
        shd = m['shd_rules']
        sch = m['sched_rules']

        def shd_v(text, **kw):
            return [(f.rule, f.severity.name) for f in
                    shd.analyze_sharded_hlo(
                        text, shd.ShardedContext(specimen='fix', **kw))]

        def sch_v(text, **kw):
            return [(f.rule, f.severity.name) for f in
                    sch.analyze_schedule_hlo(
                        text, sch.SchedContext(specimen='fix', **kw))]

        verdicts = {
            'SHD301': shd_v(td.DIVERGENT_COND),
            'SHD301-twin': shd_v(td.CONVERGENT_COND),
            'SHD302': shd_v(td.CORR_GATHER, corr_bytes=2 * 8 * 10 * 4),
            'SHD302-twin': shd_v(td.PARAM_GATHER, corr_bytes=64),
            'SHD303': shd_v(td.RESHARD_CHURN),
            'SHD303-twin': shd_v(td._independent_permutes(
                td.RESHARD_CHURN)),
            'SHD304': shd_v(td.BIG_COMM, comm_budget_bytes=1024),
            'SHD304-twin': shd_v(td.BIG_COMM, comm_budget_bytes=1 << 20),
            'SHD305': shd_v(td.DOWNCAST_REDUCE),
            'SHD305-twin': shd_v(td.F32_ACCUM_REDUCE),
            'SCH401': sch_v(ts.SERIAL_ASYNC_LOOP),
            'SCH401-twin': sch_v(ts.OVERLAPPED_ASYNC_LOOP),
            'SCH402': sch_v(ts.CHAINED_COMM, overlap_budget=0.5),
            'SCH402-twin': sch_v(ts.SLACK_COMM, overlap_budget=0.5),
            'SCH403': sch_v(ts.BIG_FETCH_LOOP),
            'SCH403-twin': sch_v(ts.SMALL_FETCH_LOOP),
            'MEM404': sch_v(ts.BIG_PEAK, peak_bytes_budget=2 << 20),
            'MEM404-twin': sch_v(ts.BIG_PEAK, peak_bytes_budget=8 << 20),
            'MEM405': sch_v(ts.RESIDUAL_LOOP, stream_full=16384,
                            stream_chunk=128),
            'MEM405-twin': sch_v(ts.CHUNK_LOOP, stream_full=16384,
                                 stream_chunk=128),
        }
        return {'comps': comps, 'verdicts': verdicts,
                'free': frozenset(hs.FREE_OPS),
                'summary': hs.schedule_summary}


# ---------------------------------------------------------------------------
# HLO computations as tapes
# ---------------------------------------------------------------------------


def hlo_tape(comp, free_ops):
    """One HLO computation as the port's tape (see the module
    docstring)."""
    tape = Tape()
    defs = {}
    for i, op in enumerate(comp.ops):
        reads = tuple(defs[r] for r in op.operand_refs() if r in defs)
        tape.buffers[i] = Buffer(nbytes=op.result_bytes, origin='op',
                                 index=i)
        t = TapeOp(index=i, name=op.opcode, reads=reads,
                   allocs=((i, op.result_bytes),),
                   out_bytes=op.result_bytes,
                   free=op.opcode in free_ops)
        shape = op.result_shape
        if op.collective_kind is not None:
            t.kind = 'collective'
            t.collective = {'kind': op.collective_kind, 'group': (0, 1),
                            'dtype': shape[0] if shape else 'f32',
                            'shape': shape[1] if shape else (),
                            'payload': op.result_bytes,
                            'async': op.is_async_start}
        elif op.async_done_kind is not None:
            refs = op.operand_refs()
            start = defs.get(refs[0]) if refs else None
            if start is not None and not comp.ops[start].is_async_start:
                start = None
            t.kind = 'wait'
            t.collective = {'start': start}
        tape.ops.append(t)
        defs[op.result] = i
    return tape


def test_schedule_model_equals_jax_on_hlo_computations(jax_side):
    checked = 0
    for label, comp, want in jax_side['comps']:
        got = schedule_tape(hlo_tape(comp, jax_side['free']))
        assert abs(got.critical_path_share - want.critical_path_share) \
            <= 1e-12, label
        if want.overlap_fraction is None:
            assert got.overlap_fraction is None, label
        else:
            assert abs(got.overlap_fraction - want.overlap_fraction) \
                <= 1e-12, label
        assert [c.program_gap_cost for c in got.collectives] == \
            [c.program_gap_cost for c in want.collectives], label
        assert (got.compute_cost, got.comm_cost) == \
            (want.compute_cost, want.comm_cost), label
        checked += 1
    assert checked >= 20
    # The compiled column-sharded top-k carries its candidate gathers.
    label, comp, want = jax_side['comps'][-1]
    assert want.collectives and label == 'sharded_topk_cols/ENTRY'


def test_summary_rounds_as_jax_on_straight_line_programs(jax_side):
    from tests.analysis.test_sched_rules import CHAINED_COMM, SLACK_COMM
    comps = {label: comp for label, comp, _ in jax_side['comps']}
    for text, label in ((CHAINED_COMM, 'CHAINED_COMM/main'),
                        (SLACK_COMM, 'SLACK_COMM/main')):
        want = jax_side['summary'](text)
        got = schedule_summary(hlo_tape(comps[label], jax_side['free']))
        for key in ('critical_path_share', 'overlap_fraction',
                    'collective_count', 'collective_bytes',
                    'serialized_collectives'):
            assert got[key] == want[key], (label, key)


# ---------------------------------------------------------------------------
# Crafted tapes: each rule's hazard and its clean twin
# ---------------------------------------------------------------------------


class Craft:
    """A tape built op by op: ``op(name, reads, out)`` returns the new
    buffer (``out`` bytes; 0 for none)."""

    def __init__(self):
        self.tape = Tape()

    def _buf(self, nbytes, shape=(), dtype='float32', index=-1,
             origin='op'):
        b = len(self.tape.buffers)
        self.tape.buffers[b] = Buffer(nbytes=nbytes, origin=origin,
                                      index=index, shape=tuple(shape),
                                      dtype=dtype)
        return b

    def arg(self, nbytes, shape=()):
        return self._buf(nbytes, shape, origin='argument')

    def op(self, name, reads=(), out=4, shape=(), dtype='float32',
           site=0, backward=False, **kw):
        i = len(self.tape.ops)
        b = self._buf(out, shape, dtype, i) if out else None
        self.tape.ops.append(TapeOp(
            index=i, name=f'aten.{name}.default', reads=tuple(reads),
            allocs=((b, out),) if b is not None else (), out_bytes=out,
            out_shapes=(tuple(shape),), site=site, backward=backward,
            provenance=f'fixture.py:{10 + i}', **kw))
        return b

    def coll(self, kind, reads, shape, nbytes=None, group=(0, 1),
             dtype='float32', site=0, async_op=False, result=None):
        i = len(self.tape.ops)
        res = shape if result is None else result
        size = 4 * _prod(res) if nbytes is None else nbytes
        b = self._buf(size, res, dtype, i)
        self.tape.ops.append(TapeOp(
            index=i, name=kind, kind='collective', reads=tuple(reads),
            allocs=((b, size),), out_bytes=size, out_shapes=(tuple(res),),
            site=site, provenance=f'fixture.py:{10 + i}',
            collective={'kind': kind, 'group': tuple(group), 'dtype': dtype,
                        'shape': tuple(shape), 'payload': size,
                        'async': async_op}))
        return b, i

    def wait(self, start, site=0):
        i = len(self.tape.ops)
        self.tape.ops.append(TapeOp(index=i, name='wait', kind='wait',
                                    site=site, collective={'start': start},
                                    provenance=f'fixture.py:{10 + i}'))


def _prod(dims):
    out = 1
    for d in dims:
        out *= d
    return out


def _shd301(twin):
    tapes = []
    for rank in (0, 1):
        c = Craft()
        x = c.arg(16)
        if twin or rank == 0:
            c.coll('all-reduce', [x], (4,))
        tapes.append(c.tape)
    return tapes, ShardedContext(specimen='fix')


def _shd302(twin):
    c = Craft()
    if twin:
        c.coll('all-gather', [c.arg(512)], (128,), result=(256,))
        return c.tape, ShardedContext(specimen='fix', corr_bytes=64)
    c.coll('all-gather', [c.arg(320)], (2, 4, 10), result=(2, 8, 10))
    return c.tape, ShardedContext(specimen='fix', corr_bytes=640)


def _shd303(twin):
    c = Craft()
    s = c.arg(128)
    a, _ = c.coll('collective-permute', [s], (4, 8))
    neg = c.op('neg', [a], out=128)
    c.coll('collective-permute', [s if twin else neg], (4, 8))
    return c.tape, ShardedContext(specimen='fix')


def _shd304(twin):
    c = Craft()
    c.coll('all-reduce', [c.arg(262144)], (1024, 64))
    return c.tape, ShardedContext(
        specimen='fix', comm_budget_bytes=(1 << 20) if twin else 1024)


def _shd305(twin):
    c = Craft()
    x = c.arg(65536)
    if twin:
        c.coll('all-reduce', [x], (128, 128))
        return c.tape, ShardedContext(specimen='fix')
    cast = c.op('_to_copy', [x], out=32768, shape=(128, 128),
                in_dtypes=('torch.float32',), out_dtypes=('torch.bfloat16',))
    c.coll('all-reduce', [cast], (128, 128), nbytes=32768, dtype='bfloat16')
    return c.tape, ShardedContext(specimen='fix')


def _sch401(twin):
    c = Craft()
    carry = c.arg(256)
    for _ in range(2):                       # two iterations of a loop
        out, start = c.coll('all-reduce', [carry], (64,), site=7,
                            async_op=True)
        if twin:
            c.op('mul', [carry], out=256, site=8)
        c.wait(start, site=9)
        carry = c.op('mul', [out], out=256, site=10)
    return c.tape, SchedContext(specimen='fix')


def _sch402(twin):
    c = Craft()
    g, h = c.arg(4096), c.arg(4096)
    if twin:
        ar, _ = c.coll('all-reduce', [g], (1024,))
        m = c.op('mul', [h], out=4096)
        c.op('add', [ar, m], out=4096)
    else:
        n = c.op('neg', [g], out=4096)
        ar, _ = c.coll('all-reduce', [n], (1024,))
        c.op('neg', [ar], out=4096)
    return c.tape, SchedContext(specimen='fix', overlap_budget=0.5)


def _sch403(twin):
    c = Craft()
    table = c.arg(4 << 20)
    acc = c.arg(1 << 20)
    size = 256 if twin else 1 << 20
    for _ in range(4):                       # a chunk loop's iterations
        got = c.op('index_select', [table, acc], out=size, site=3)
        m = c.op('mul', [got], out=size, site=4)
        acc = c.op('add', [m, acc], out=size, site=5)
    return c.tape, SchedContext(specimen='fix')


def _mem404(twin):
    c = Craft()
    p = c.arg(1 << 20)
    a = c.op('neg', [p], out=1 << 20, stage='psi1')
    b = c.op('neg', [a], out=1 << 20, stage='consensus_iter')
    c.op('add', [a, b], out=1 << 20)
    return c.tape, SchedContext(
        specimen='fix', peak_bytes_budget=(8 << 20) if twin else 2 << 20)


def _mem405(twin):
    c = Craft()
    shape = (2048, 128) if twin else (128, 2048, 128)
    x = c.arg(1 << 16)
    mask = c.op('gt', [x], out=_prod(shape), shape=shape, dtype='bool')
    c.op('where', [mask], out=1 << 16, backward=True)
    return c.tape, SchedContext(specimen='fix', stream_full=16384,
                                stream_chunk=128)


CRAFTED = {'SHD301': _shd301, 'SHD302': _shd302, 'SHD303': _shd303,
           'SHD304': _shd304, 'SHD305': _shd305, 'SCH401': _sch401,
           'SCH402': _sch402, 'SCH403': _sch403, 'MEM404': _mem404,
           'MEM405': _mem405}


def _verdict(rule, twin):
    tape, ctx = CRAFTED[rule](twin)
    if rule.startswith('SHD'):
        found = analyze_sharded_tape(tape, ctx)
    else:
        found = analyze_schedule_tape(tape, ctx)
    return [(f.rule, f.severity.name) for f in found]


@pytest.mark.parametrize('twin', [False, True], ids=['hazard', 'twin'])
@pytest.mark.parametrize('rule', sorted(CRAFTED))
def test_rule_verdict_equals_jax(jax_side, rule, twin):
    want = jax_side['verdicts'][rule + ('-twin' if twin else '')]
    got = _verdict(rule, twin)
    assert sorted(set(got)) == sorted(set(want))
    assert bool(got) is not twin


def test_collective_table_counts_each_collective_once():
    tapes, _ = _shd301(True)
    assert collective_table(tapes[0]) == {
        'ops': {'all-reduce': {'count': 1, 'bytes': 16}}, 'count': 1,
        'bytes': 16}
    c = Craft()
    assert collective_table(c.tape) == {'ops': {}, 'count': 0, 'bytes': 0}
