"""Distributed subsystem: fault tolerance and the domain-decomposition
science-kernel backends.

``repro_torch.distributed.domain`` registers the sharded ``torch_shard``
backends (slab/pencil, block, pose and l-slab decompositions over a mesh of
shard places) for every science-kernel family, and
``repro_torch.distributed.shard_kernels`` the composites of the hand-written
kernels (``shard_cuda``, ``shard_triton``); ``repro_torch.distributed.
collectives`` holds the halo-exchange/psum vocabulary they share.  None is
imported here: importing this package is side-effect free (no device
query); the kernel catalogue (``import repro_torch.kernels``) pulls
``domain`` and ``shard_kernels`` in explicitly.
"""
