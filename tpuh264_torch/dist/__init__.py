"""Distribution layer of the port: the (streams, rows) mesh over
torch.distributed process groups (`mesh`), the multi-host worker
(`multihost`) and the collectives they share (`collectives`).

Port of tpuh264/dist/.  Lazy imports, as in the JAX package: a worker
joins its process group before it touches the kernels, and
kernels/pframe.py imports `collectives` from here without pulling in the
mesh (which imports the kernels).
"""

__all__ = ["make_codec_mesh", "sharded_encode_step", "mesh", "multihost"]


def __getattr__(name):
    if name in ("make_codec_mesh", "sharded_encode_step"):
        from . import mesh

        return getattr(mesh, name)
    if name in ("mesh", "multihost"):
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(name)
