"""Core: the portable-kernel registry, tuning and the paper's metrics."""

from repro_torch.core.portable import (  # noqa: F401
    Backend,
    BackendUnavailableError,
    KernelRegistry,
    PortableKernel,
    TunableSpace,
    get_kernel,
    max_abs_err,
    register_kernel,
    registry,
    time_call,
)
from repro_torch.core.tuning import (  # noqa: F401
    TuningCache,
    TuningKey,
    TuningResult,
    cached_best_params,
    tune,
)
from repro_torch.core.metrics import (  # noqa: F401
    Efficiency,
    babelstream_bandwidth,
    babelstream_bytes,
    hartree_fock_quartets,
    minibude_gflops,
    minibude_ops,
    phi_bar,
    stencil7_effective_bandwidth,
    stencil7_effective_bytes,
)
