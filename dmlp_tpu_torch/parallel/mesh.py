"""Device-mesh construction — port of ``dmlp_tpu/parallel/mesh.py``.

The reference program builds a 2D process grid by hand
(``MPI_Dims_create`` -> ``MPI_Cart_create`` -> ``MPI_Cart_sub`` row and
column communicators). Here the grid is one
``torch.distributed.device_mesh.DeviceMesh`` of shape (R, C) with the
dimension names ("data", "query"), built over an initialized process
group (``parallel.distributed.initialize``, the ``MPI_Init`` analog): rows
shard the dataset, columns shard the queries, and each dimension's
process group stands in for one family of sub-communicators. The layout is
row-major, as the reference's ``Mesh(devices.reshape(R, C))``: rank
r * C + c sits at (r, c).

The mesh's device type is where its collectives' tensors live: "cuda"
under NCCL, "cpu" under gloo. Under gloo the ranks may still compute on a
card; ``parallel.collectives`` then stages the candidate lists through
host memory.
"""

from __future__ import annotations

from typing import Optional, Tuple

DATA_AXIS = "data"    # shards the dataset (the reference's grid rows)
QUERY_AXIS = "query"  # shards the queries (the reference's grid columns)


def balanced_dims(n: int) -> Tuple[int, int]:
    """Near-square factorization R x C = n with R >= C: the analog of
    ``MPI_Dims_create(size, 2, dims)``. The data axis gets the larger
    factor (datasets are usually bigger than query batches)."""
    c = int(n ** 0.5)
    while c > 1 and n % c != 0:
        c -= 1
    return n // c, c


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              device_type: Optional[str] = None):
    """The 2D ("data", "query") ``DeviceMesh`` over the whole initialized
    process group. ``shape=None`` factorizes the world size
    (:func:`balanced_dims`); an explicit shape must multiply to it.
    ``device_type`` defaults to the process group's: "cuda" under NCCL,
    "cpu" under gloo."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call dmlp_tpu_torch.parallel.distributed."
            "initialize() (the MPI_Init analog) before make_mesh()")
    world = dist.get_world_size()
    if shape is None:
        shape = balanced_dims(world)
    r, c = shape
    if r * c != world:
        raise ValueError(f"mesh shape {tuple(shape)} != world size {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (r, c),
                            mesh_dim_names=(DATA_AXIS, QUERY_AXIS))


def mesh_coords(mesh) -> Tuple[int, int]:
    """This rank's (data, query) coordinate on ``mesh``."""
    r, c = mesh.get_coordinate()
    return int(r), int(c)
