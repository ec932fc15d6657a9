"""A reference file that no harness file names: it counts its calls and
hands them to the dense reference.  Like every reference, it imports
nothing of the program."""
from collections import Counter

from bench import reference

CALLS: Counter = Counter()


def logit_gaps(*args, **kw):
    CALLS["logit_gaps"] += 1
    return reference.logit_gaps(*args, **kw)
