"""The port is importable where JAX and imageio are not: importing every
``irn_tpu_torch`` module pulls in neither. Checked in a fresh interpreter,
since this test process imports JAX through conftest.py."""

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
             if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'imageio'))
assert not bad, bad
assert 'triton' not in sys.modules
print(len(names))
"""


def test_port_imports_without_jax_or_imageio():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 15
