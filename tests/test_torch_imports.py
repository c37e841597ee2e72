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
# nothing is built at import: the native CRF library loads at first use
assert not sys.modules['irn_tpu_torch.ops.native']._loaded
print(' '.join(names))
print(len(names))
"""

# the modules of the later slices
SLICE = ("irn_tpu_torch.data.transforms", "irn_tpu_torch.models.cam",
         "irn_tpu_torch.ops.crf", "irn_tpu_torch.ops.crf_device",
         "irn_tpu_torch.ops.native", "irn_tpu_torch.pipeline.stages_cam",
         # the make_ins_seg / eval_ins_seg / make_cocoann slice
         "irn_tpu_torch.ops.cc", "irn_tpu_torch.ops.centroids",
         "irn_tpu_torch.ops.ccl", "irn_tpu_torch.eval.insseg",
         "irn_tpu_torch.eval.coco",
         # the train_irn slice
         "irn_tpu_torch.data.loader", "irn_tpu_torch.train.optim",
         "irn_tpu_torch.train.irn_train", "irn_tpu_torch.pipeline.common",
         # the train_cam slice
         "irn_tpu_torch.train.cam_train", "irn_tpu_torch.utils.profiling",
         # several GPUs and processes
         "irn_tpu_torch.parallel", "irn_tpu_torch.parallel.mesh",
         # the row-sharded walk
         "irn_tpu_torch.parallel.rw_sharded")


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
    lines = proc.stdout.strip().splitlines()
    assert int(lines[-1]) >= 27
    assert set(SLICE) <= set(lines[-2].split())


def test_import_probe_catches_irn_tpu():
    """The probe fails once any ``irn_tpu`` module is loaded (a framework-free
    one too), while ``irn_tpu_torch`` itself is not caught."""
    proc = _run_probe("import irn_tpu.ops.paths\n")
    assert proc.returncode != 0
    assert "irn_tpu.ops.paths" in proc.stderr
