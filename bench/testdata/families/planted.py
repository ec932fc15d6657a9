"""A family file that no harness file names: it counts each call of the
family contract and hands it to the dense family, so a test can see that
the harness reaches the model only through the file a configuration names."""
from collections import Counter

from bench.families import dense

CALLS: Counter = Counter()


def _counted(name):
    def call(*args, **kw):
        CALLS[name] += 1
        return getattr(dense, name)(*args, **kw)
    call.__name__ = name
    return call


build_arch = _counted("build_arch")
param_tree = _counted("param_tree")
decode_step = _counted("decode_step")
prefill_chunk = _counted("prefill_chunk")
int8_step_bound_s = _counted("int8_step_bound_s")
