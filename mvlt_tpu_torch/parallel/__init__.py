"""Multi-device layer of the port: the (data, model) mesh on
``torch.distributed``, the partition rules and the collectives
(counterpart of ``mvlt_tpu/parallel``)."""

from mvlt_tpu_torch.parallel.mesh import (Mesh, build_mesh,
                                          initialize_distributed)
from mvlt_tpu_torch.parallel.partition import (batch_rows, param_shardings,
                                               partition_spec_for_path)

__all__ = ["Mesh", "build_mesh", "initialize_distributed", "batch_rows",
           "param_shardings", "partition_spec_for_path"]
