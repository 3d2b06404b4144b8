"""Data parallelism on ``torch.distributed`` (counterpart of
``multimodal_fusion_tpu.parallel``): the mesh and its collectives
(``mesh``), the multi-process gang (``multihost``) and the dry run
(``dryrun``)."""

from multimodal_fusion_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    all_gather_rows,
    all_reduce,
    all_reduce_grads,
    make_mesh,
    make_mesh_2d,
    mesh_from_shape,
    place_batch,
    replicate,
)
