"""The port is importable where JAX and imageio are not, and stands apart
from the JAX package: importing every ``irn_tpu_torch`` module pulls in
none of JAX, imageio or ``irn_tpu``. Checked in a fresh interpreter, since
this test process imports JAX through conftest.py."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import irn_tpu_torch
names = [m.name for m in pkgutil.walk_packages(irn_tpu_torch.__path__,
                                               'irn_tpu_torch.')]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'imageio',
                                        'irn_tpu'))
assert not bad, bad
assert 'triton' not in sys.modules
print(len(names))
"""


def _run_probe(prelude: str = ""):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-c", prelude + _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=240,
    )


def test_port_imports_without_jax_or_imageio():
    """Also: no module whose top-level name is exactly ``irn_tpu``."""
    proc = _run_probe()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 15


def test_import_probe_catches_irn_tpu():
    """The probe fails once any ``irn_tpu`` module is loaded (a framework-free
    one too), while ``irn_tpu_torch`` itself is not caught."""
    proc = _run_probe("import irn_tpu.ops.paths\n")
    assert proc.returncode != 0
    assert "irn_tpu.ops.paths" in proc.stderr
