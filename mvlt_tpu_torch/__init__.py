"""MVLT on PyTorch and CUDA: the port of :mod:`mvlt_tpu` to an NVIDIA H100.

Importing the package pulls in ``torch`` and nothing of JAX or flax; the only
parts of :mod:`mvlt_tpu` it uses are the JAX-free host modules
(:mod:`mvlt_tpu.config`, :mod:`mvlt_tpu.text`). The CUDA kernels are built at
first use (:mod:`mvlt_tpu_torch.ops.kernels`).
"""
