"""Distribution layer: collectives and sharding specs for the (data, model)
meshes of ``launch/mesh.py``.

PyTorch counterpart of ``repro.dist``: :mod:`repro_torch.dist.collectives`
(the H-tree all-reduce and the ``allreduce`` hook that
``Runtime.collective`` selects, over gloo process groups) and
:mod:`repro_torch.dist.sharding` (the spec builders for params, inputs and
the decode state, and the blocks they give each rank).  The reference's
``dist/compat.py`` only papers over JAX API drift (``shard_map``'s
location, the static axis size inside a mapped body): nothing of it has a
counterpart here.
"""
