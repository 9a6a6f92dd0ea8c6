"""MVLT on PyTorch and CUDA: the port of :mod:`mvlt_tpu` to an NVIDIA H100.

Importing the package pulls in ``torch`` and nothing of JAX, flax or
:mod:`mvlt_tpu`: the port keeps its own copies of the host modules it needs
(:mod:`mvlt_tpu_torch.config`, the tokenizer in :mod:`mvlt_tpu_torch.text`,
the datasets and loader in :mod:`mvlt_tpu_torch.data`, ...). The CUDA
kernels are built at first use (:mod:`mvlt_tpu_torch.ops.kernels`). Entry
points: the model builders of :mod:`mvlt_tpu_torch.flagship` (serving and
train steps of every task) and the VQA task driver, ``python -m
mvlt_tpu_torch.run_vqa``.
"""
