"""The port's source (SRC) tier: captured code in the place of jitted code.

Each SRC101-103 case is a pair written line for line: a JAX-idiom module
(``jax.jit``) and its port counterpart (``compiled(...)``, a lambda
calling a method, a ``with torch.cuda.graph(...)`` block). The JAX
package's tier on the first and the port's on the second give the same
rule, severity and line. The modules are strings written to
``tmp_path``: they are parsed, never run.
"""

import ast
import os
import textwrap

import pytest

from dgmc_tpu_torch.analysis import source_rules
from dgmc_tpu_torch.analysis.source_rules import (captured_regions,
                                                  iter_source_files,
                                                  lint_source_file,
                                                  lint_source_tree)
from tests.torch_jax_worker import jax_worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _src(text):
    return textwrap.dedent(text).lstrip('\n')


#: (case, JAX idiom, port idiom): the flagged line is the same line.
PAIRS = [
    ('SRC101-self', _src('''
        import jax


        class Hoarder:
            @jax.jit
            def step(self, x):
                self.last = x
                return x * 2.0
        '''), _src('''
        from dgmc_tpu_torch.train.compiled import compiled


        class Hoarder:
            # captured: compiled(self.step, ...) in __init__, below
            def step(self, x):
                self.last = x
                return x * 2.0

            def __init__(self, device):
                self.run = compiled(self.step, device)
        ''')),
    ('SRC101-global', _src('''
        import jax

        LAST = None


        def step(x):
            global LAST
            LAST = x
            return x


        step = jax.jit(step)
        '''), _src('''
        from dgmc_tpu_torch.train.compiled import compiled

        LAST = None


        def step(x):
            global LAST
            LAST = x
            return x


        step = compiled(step, 'cuda')
        ''')),
    ('SRC102-float', _src('''
        import jax


        @jax.jit
        def host_sync(x):
            scale = float(x)
            return x * scale
        '''), _src('''
        from dgmc_tpu_torch.train.compiled import compiled


        # captured: compiled(host_sync, ...) below
        def host_sync(x):
            scale = float(x)
            return x * scale
        step = compiled(host_sync, 'cuda')
        ''')),
    ('SRC102-item', _src('''
        import jax


        def make_query(model):
            def query(x):
                return x * x.item()
            q = jax.jit(query)
            return q
        '''), _src('''
        from dgmc_tpu_torch.train.compiled import compiled


        def make_query(model, device):
            def query(x):
                return x * x.item()
            q = compiled(lambda *a: query(*a), device)
            return q
        ''')),
    ('SRC102-asarray', _src('''
        import jax
        import numpy as np


        @jax.jit
        def to_host(x):
            return np.asarray(x)
        '''), _src('''
        import numpy as np
        from dgmc_tpu_torch.train.compiled import Compiled


        # captured: Compiled(to_host, ...) below
        def to_host(x):
            return np.asarray(x)
        step = Compiled(to_host, 'cuda')
        ''')),
    ('SRC103', _src('''
        import jax


        def build(fns):
            out = []
            for f in fns:
                out.append(jax.jit(f))
            return out
        '''), _src('''
        from dgmc_tpu_torch.train.compiled import compiled


        def build(fns, device):
            out = []
            for f in fns:
                out.append(compiled(f, device))
            return out
        ''')),
]


def _rsl(findings):
    return [(f.rule, f.severity.name, int(f.where.rsplit(':', 1)[1]))
            for f in findings]


@pytest.mark.parametrize('case,jax_src,port_src', PAIRS,
                         ids=[p[0] for p in PAIRS])
def test_src_pair_fires_at_the_jax_line(tmp_path, case, jax_src, port_src):
    (tmp_path / 'jax_mod.py').write_text(jax_src)
    (tmp_path / 'port_mod.py').write_text(port_src)
    with jax_worker('dgmc_tpu.analysis.source_rules') as m:
        want = _rsl(m['source_rules'].lint_source_file(
            str(tmp_path / 'jax_mod.py')))
    got = _rsl(lint_source_file(str(tmp_path / 'port_mod.py')))
    assert got == want
    assert [r for r, _, _ in got] == [case.split('-')[0]]


@pytest.mark.parametrize('call,what', [
    ('x.cpu()', '`.cpu()`'),
    ('x.tolist()', '`.tolist()`'),
    ('x.numpy()', '`.numpy()`'),
    ('torch.cuda.synchronize()', '`.synchronize()`'),
    ('int(x.sum())', '`int(...)` on a non-constant'),
    ('bool(x.any())', '`bool(...)` on a non-constant'),
])
def test_src102_flags_the_ports_host_reads(tmp_path, call, what):
    p = tmp_path / 'mod.py'
    p.write_text(_src(f'''
        import torch
        from dgmc_tpu_torch.train.compiled import compiled


        def step(x):
            y = {call}
            return x
        step = compiled(step, 'cuda')
        '''))
    (f,) = lint_source_file(str(p))
    assert (f.rule, f.where.rsplit(':', 1)[1]) == ('SRC102', '6')
    assert f.message.startswith(what) and '`step`' in f.message
    assert f.context == f'y = {call}'


def test_graph_block_body_is_captured_code(tmp_path):
    p = tmp_path / 'mod.py'
    p.write_text(_src('''
        import torch


        def capture(fn, x):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = fn(x)
                n = out.item()
            total = out.item()
            return graph, out, n, total
        '''))
    (f,) = lint_source_file(str(p))
    assert f.rule == 'SRC102' and f.where.endswith(':8')
    assert '`capture (torch.cuda.graph block)`' in f.message


def test_graph_in_loop_and_clean_captures(tmp_path):
    p = tmp_path / 'mod.py'
    p.write_text(_src('''
        import torch
        from dgmc_tpu_torch.train.compiled import compiled


        def graphs(n):
            return [torch.cuda.CUDAGraph() for _ in range(n)]


        def per_call(xs, device):
            for x in xs:
                g = torch.cuda.CUDAGraph()
                def inner(y):
                    return compiled(lambda z: z, device)(y)
            return g, inner


        def clean(x):
            return x * 2.0 + float(1)
        step = compiled(clean, 'cuda')
        '''))
    assert _rsl(lint_source_file(str(p))) == [('SRC103', 'WARNING', 11)]


def test_src104_does_not_fire_on_the_port(tmp_path):
    """A mutable default on a captured function: the JAX tier's SRC104
    fires on the ``static_argnums`` counterpart, the port's tier on
    ``compiled(...)`` stays silent (it takes no static argument; see
    ``--explain SRC104``)."""
    (tmp_path / 'jax_mod.py').write_text(_src('''
        import functools

        import jax


        @functools.partial(jax.jit, static_argnums=(1,))
        def scaled(x, cfg=[1, 2]):
            return x * cfg[0]
        '''))
    (tmp_path / 'port_mod.py').write_text(_src('''
        import functools

        from dgmc_tpu_torch.train.compiled import compiled


        def scaled(x, cfg=[1, 2]):
            return x * cfg[0]
        step = functools.partial(compiled, scaled)('cuda')
        step = compiled(scaled, 'cuda')
        '''))
    with jax_worker('dgmc_tpu.analysis.source_rules') as m:
        want = _rsl(m['source_rules'].lint_source_file(
            str(tmp_path / 'jax_mod.py')))
    assert want == [('SRC104', 'WARNING', 7)]
    assert lint_source_file(str(tmp_path / 'port_mod.py')) == []
    assert not any(f.rule == 'SRC104' for f in lint_source_tree(
        os.path.join(REPO, 'dgmc_tpu_torch')))


@pytest.mark.parametrize('rel,want', [
    (('train', 'steps.py'), ['<lambda>', 'body', 'body']),
    (('serve', 'engine.py'), ['_query', '_embed_query', '_rerank']),
    (('train', 'compiled.py'), ['_capture (torch.cuda.graph block)']),
])
def test_captured_functions_of_the_port(rel, want):
    """The defs the port's tier takes as captured: the train and eval
    steps' ``body`` (through ``_Jit``'s lambda), the engine's query,
    embed and rerank functions (``compiled(self._rerank if ... else
    self._query)``) and the capture block itself."""
    path = os.path.join(REPO, 'dgmc_tpu_torch', *rel)
    tree = ast.parse(open(path).read(), path)
    assert [r.name for r in captured_regions(tree)] == want


def test_the_ports_tree_has_no_source_findings():
    roots = [os.path.join(REPO, 'dgmc_tpu_torch'),
             os.path.join(REPO, 'chip_smoke.py')]
    assert source_rules.lint_source_paths(roots) == []


def test_syntax_error_is_src100(tmp_path):
    p = tmp_path / 'broken.py'
    p.write_text('def f(:\n    pass\n')
    (f,) = lint_source_file(str(p))
    assert f.rule == 'SRC100' and f.where == f'{p}:1'


def test_refuses_bytecode(tmp_path):
    pyc = tmp_path / 'mod.pyc'
    pyc.write_bytes(b'\x00\x00\x00\x00')
    with pytest.raises(ValueError, match='refusing to scan bytecode'):
        lint_source_file(str(pyc))
    d = tmp_path / '__pycache__'
    d.mkdir()
    (d / 'mod.py').write_text('x = 1\n')
    with pytest.raises(ValueError, match='refusing to scan bytecode'):
        lint_source_file(str(d / 'mod.py'))


def test_walker_skips_bytecode_and_the_kernel_build_dir(tmp_path):
    (tmp_path / 'ok.py').write_text('x = 1\n')
    for name in ('__pycache__', '_build'):
        d = tmp_path / name
        d.mkdir()
        (d / 'stale.py').write_text('x = 1\n')
    (tmp_path / '__pycache__' / 'stale.pyc').write_bytes(b'\x00')
    found = [os.path.basename(p) for p in iter_source_files(str(tmp_path))]
    assert found == ['ok.py']
