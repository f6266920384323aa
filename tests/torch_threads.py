"""The port's tests run torch on one CPU thread: the rule, in one place.

The suite runs its files on several worker processes of one host (pytest
-n 6 --dist loadfile). With torch's CPU thread pool at its default, each
worker's pool asks for every core, and the plain engines' many small ops
spend their time in the pool's barriers (on an 8-core host, a CG
posterior test that takes 6 s alone took 149 s among 6 workers). The
results do not depend on the thread count.

Every ``tests/test_torch_*.py`` imports ``one_torch_thread`` from here;
the import puts the autouse fixture in the module's namespace, which is
what applies it (tests/test_torch_slice.py checks that every such file
does, and that none sets the count itself). It is module-scoped, so it
also covers the module-scoped fixtures that build a file's shared
problem. The package itself sets no thread count: a user's process and
the benchmark keep their own.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """torch on one thread while the module's tests and fixtures run; the
    previous count afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
