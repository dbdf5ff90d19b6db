"""tpuprt_torch: the PyTorch + CUDA port of tpu-prt (the JAX package in
``tpuprt/``), for an NVIDIA Hopper GPU.

Module layout and names follow ``tpuprt`` one to one, so each counterpart is
easy to find. Plain tensor code is PyTorch; the BVH traversal kernels and
the dense ray-triangle kernel are hand-written CUDA
(``ops/csrc/bvh_tiles.cu``, ``ops/csrc/bvh_rows.cu``,
``ops/csrc/mt_best.cu``). The package imports neither
``jax`` nor ``tpuprt``; only the tests import both to hold the port against
the reference.
"""
import torch as _torch

# Geometry is precision-critical (a hit point pushed inside a surface makes
# it shadow itself), so nothing may run in TF32: the port computes in full
# f32 everywhere, as tpuprt/__init__.py forces for the TPU's matrix unit.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
