"""The multi-device solve: a mesh of devices, the snapshot placed on it,
and the explicit-collective shard bodies.

Mirrors ``kube_batch_tpu/parallel``.  ``mesh.py`` holds the mesh, the
placement, the knobs and the entry points (each with its sentinel twin);
``shard_solve.py`` the shard bodies and their collectives;
``distributed.py`` maps a mesh onto ``torch.distributed`` ranks."""

__all__ = ["Mesh", "make_mesh", "sharded_allocate_solve", "snapshot_shardings"]


def __getattr__(name):
    if name in __all__:
        from kube_batch_tpu_torch.parallel import mesh

        return getattr(mesh, name)
    raise AttributeError(name)
