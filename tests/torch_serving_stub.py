"""``tests/serving_stub.py`` over the port's classes, for
``tests/test_torch_http.py`` (not collected: no ``test_`` prefix).

The stub stands in for ``ContinuousScheduler`` behind the front door and
raises ``RateLimited`` / ``Overloaded``; the port's ``FrontDoor`` catches
the port's classes, so this module is the reference stub's source run with
its three ``repro.serve`` imports pointed at ``repro_torch.serve`` (the
port's ``Request``, policy exceptions and ``BlockAllocator``): the same
stub, line for line, and nothing to keep in step by hand.
"""
from __future__ import annotations

from pathlib import Path

_SOURCE = (Path(__file__).with_name("serving_stub.py")).read_text()
assert _SOURCE.count("from repro.serve.") == 3, "serving_stub.py's imports changed"
exec(compile(_SOURCE.replace("from repro.serve.", "from repro_torch.serve."),
             __file__, "exec"))
