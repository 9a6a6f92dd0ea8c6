"""MVLT on PyTorch and CUDA: the port of :mod:`mvlt_tpu` to an NVIDIA H100.

Importing the package pulls in ``torch`` and nothing of JAX, flax or
:mod:`mvlt_tpu`: the port keeps its own copies of the host modules it needs
(:mod:`mvlt_tpu_torch.config`). The CUDA kernels are built at first use
(:mod:`mvlt_tpu_torch.ops.kernels`). Entry points: the VQA forward and the
VQA finetune train step in :mod:`mvlt_tpu_torch.flagship`.
"""
