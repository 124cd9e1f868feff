"""Core: the portable-kernel registry, tuning, the paper's metrics and the
roofline."""

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
from repro_torch.core.roofline import (  # noqa: F401
    TPU_V5E,
    ChipSpec,
    RooflineTerms,
    model_flops,
    roofline_from_cost,
)
from repro_torch.core.op_analysis import (  # noqa: F401
    CollectiveStats,
    collective_stats,
)
