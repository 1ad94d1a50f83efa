"""Session set-up that must run once, before any pytest-xdist worker starts.

``tests/test_native.py`` (and the port's signal-chain and BER tests) call
``viterbidecodercpp_tpu.utils.native.ensure_built()`` at import.  On a fresh
checkout that compiles ``libvdtsigchain.so`` in place, and under ``-n N``
every worker collects every module, so N workers would write and load the
same file at once; a worker that loads it mid-write skips the whole module.
Building it here, on the controller, leaves the workers a finished file.

The build runs in a subprocess so that this process imports no jax before
``tests/conftest.py`` has set its XLA flags.  It builds and skips nothing
else: without g++ the library stays missing and the native tests skip as
before.
"""

import os
import subprocess
import sys

_ROOT = os.path.dirname(os.path.abspath(__file__))
_BUILD = ("from viterbidecodercpp_tpu.utils import native; "
          "native.ensure_built()")


def pytest_configure(config):
    if hasattr(config, "workerinput"):
        return  # an xdist worker: the controller has built it already
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    env.setdefault("JAX_PLATFORMS", "cpu")
    try:
        subprocess.run([sys.executable, "-c", _BUILD], cwd=_ROOT, env=env,
                       capture_output=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired):
        pass  # the tests' own ensure_built() decides, as before
