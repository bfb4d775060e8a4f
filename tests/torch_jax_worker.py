"""Load the JAX serving worker's modules for the port's tests.

``dgmc_tpu.serve`` and ``dgmc_tpu.obs.qtrace`` import three leaf modules
of ``dgmc_tpu.analysis`` (``findings``, ``hlo_comm``, ``recompile``),
which import no JAX, while the package root does not import under every
JAX version. :func:`jax_worker` imports the named modules with
``dgmc_tpu.analysis`` replaced by a stub package whose ``__path__`` is
the analysis directory (so the leaves load from their files and the
package's ``__init__`` never runs). On exit it removes from
``sys.modules`` every ``dgmc_tpu`` module it added, the stub included,
and their attributes on the packages that stay, so no other test in the
process can reach them: the JAX package's own tests fail or pass as they
do without this module.
"""

import contextlib
import importlib
import os
import sys
import types

__all__ = ['jax_worker']


def _ours(name):
    return name == 'dgmc_tpu' or name.startswith('dgmc_tpu.')


@contextlib.contextmanager
def jax_worker(*names):
    """Yield ``{short name: module}`` for the dotted ``names`` (e.g.
    ``'dgmc_tpu.serve.service'`` as ``'service'``)."""
    before = set(sys.modules)
    try:
        import dgmc_tpu
        if 'dgmc_tpu.analysis' not in sys.modules:
            stub = types.ModuleType('dgmc_tpu.analysis')
            stub.__path__ = [os.path.join(os.path.dirname(dgmc_tpu.__file__),
                                          'analysis')]
            sys.modules['dgmc_tpu.analysis'] = stub
        yield {n.rsplit('.', 1)[-1]: importlib.import_module(n)
               for n in names}
    finally:
        added = [m for m in set(sys.modules) - before if _ours(m)]
        for name in added:
            mod = sys.modules.pop(name)
            parent, _, leaf = name.rpartition('.')
            owner = sys.modules.get(parent)
            if owner is not None and getattr(owner, leaf, None) is mod:
                delattr(owner, leaf)


@contextlib.contextmanager
def jax_analysis(*names):
    """:func:`jax_worker` for the JAX package's trace tier
    (``dgmc_tpu.analysis.jaxpr_rules``, ``registry``) under the installed
    JAX, which moved two names that tier reads: ``jax.core.ClosedJaxpr``
    / ``JaxprEqn`` (now in ``jax.extend.core``) and
    ``source_info_util.user_frame``, which takes a traceback where the
    tier passes a ``SourceInfo``. Both are bridged for the block and
    restored after it; nothing in the JAX package changes."""
    import jax
    import jax.extend.core as jcore
    from jax._src import source_info_util as siu
    added = [n for n in ('ClosedJaxpr', 'JaxprEqn')
             if not hasattr(jax.core, n)]
    for n in added:
        setattr(jax.core, n, getattr(jcore, n))
    user_frame = siu.user_frame
    siu.user_frame = lambda info: user_frame(getattr(info, 'traceback',
                                                     info))
    try:
        with jax_worker(*names) as mods:
            yield mods
    finally:
        siu.user_frame = user_frame
        for n in added:
            delattr(jax.core, n)
