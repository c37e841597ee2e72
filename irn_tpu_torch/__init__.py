"""irn_tpu_torch — the IRNet pipeline of :mod:`irn_tpu` ported to PyTorch
and CUDA for one NVIDIA H100 (Hopper).

It sits beside the JAX package, which stays the reference: each module
mirrors its ``irn_tpu`` counterpart's path and keeps its public layouts.
It imports ``torch`` but never ``jax``, and nothing of ``irn_tpu``: what it
needs of the JAX package's framework-free modules (``Config``, the path
geometry, the weight converter, the semseg scores) it holds as its own
copies under the same names.

Subpackages
-----------
- ``irn_tpu_torch.ops``       random walk, path affinity, resize, and the
                              hand-written CUDA kernels (``csrc/``) with
                              their plain PyTorch twins.
- ``irn_tpu_torch.models``    ResNet-50 (frozen BN) and IRNet, NCHW.
- ``irn_tpu_torch.pipeline``  the CLI (``python -m
                              irn_tpu_torch.pipeline.run``) and stages.
- ``irn_tpu_torch.data``      image I/O, the raw image source, synthetic tree.
- ``irn_tpu_torch.utils``     checkpoint pickle I/O, JAX -> torch weights.
"""

__version__ = "0.1.0"
