"""Hand-written Hopper kernels (kernel.py + ops.py + ref.py each).

Importing this package registers the backends of every kernel ported so
far in ``repro_torch.core.portable.registry``.
"""

import repro_torch.kernels.babelstream.ops  # noqa: F401
import repro_torch.kernels.flash_attention.ops  # noqa: F401
import repro_torch.kernels.hartree_fock.ops  # noqa: F401
import repro_torch.kernels.minibude.ops  # noqa: F401
import repro_torch.kernels.rwkv6.ops  # noqa: F401
import repro_torch.kernels.stencil7.ops  # noqa: F401

# last (they import the ops modules above): attach the sharded
# `torch_shard` backends + shard tunables, then the composites of the
# hand-written kernels (`shard_cuda`, `shard_triton`) with their kernel-tile
# x shard tunable spaces
import repro_torch.distributed.domain  # noqa: F401
import repro_torch.distributed.shard_kernels  # noqa: F401
