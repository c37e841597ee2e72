"""irn_tpu_torch — the IRNet pipeline of :mod:`irn_tpu` ported to PyTorch
and CUDA for one NVIDIA H100 (Hopper).

It sits beside the JAX package, which stays the reference: each module
mirrors its ``irn_tpu`` counterpart's path and keeps its public layouts.
It imports ``torch`` but never ``jax``, and nothing of ``irn_tpu``: what it
needs of the JAX package's framework-free modules (``Config``, the path
geometry, the weight converter, the semseg scores, the image transforms,
the VOC sources, the native CRF loader) it holds as its own copies under
the same names.

Subpackages
-----------
- ``irn_tpu_torch.ops``       random walk, path affinity, resize, the CRFs
                              (native lattice via ctypes, device landmark
                              CRF), and the hand-written CUDA kernels
                              (``csrc/``) with their plain PyTorch twins.
- ``irn_tpu_torch.models``    ResNet-50 (frozen BN), CAMNet and IRNet, NCHW.
- ``irn_tpu_torch.pipeline``  the CLI (``python -m
                              irn_tpu_torch.pipeline.run``) and the ten
                              stages: train_cam, make_cam, eval_cam,
                              cam_to_ir_label, train_irn, make_sem_seg,
                              eval_sem_seg, make_ins_seg, eval_ins_seg,
                              make_cocoann.
- ``irn_tpu_torch.train``     poly SGD and the ``.train`` state, the CAMNet
                              and IRNet train steps.
- ``irn_tpu_torch.data``      image I/O, transforms, VOC sources, the batch
                              loader, synthetic tree.
- ``irn_tpu_torch.utils``     checkpoint pickle I/O, weights between the
                              JAX and torch layouts, logging, the profiler
                              window.
"""

__version__ = "0.1.0"
