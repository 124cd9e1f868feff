"""Hand-written Hopper kernels (kernel.py + ops.py + ref.py each).

Importing this package registers the backends of every kernel ported so
far in ``repro_torch.core.portable.registry``.
"""

import repro_torch.kernels.babelstream.ops  # noqa: F401
import repro_torch.kernels.flash_attention.ops  # noqa: F401
import repro_torch.kernels.hartree_fock.ops  # noqa: F401
import repro_torch.kernels.minibude.ops  # noqa: F401
import repro_torch.kernels.stencil7.ops  # noqa: F401

