"""CLI: ``python -m repro_torch.core.telemetry summarize <trace>``."""

import sys

from repro_torch.core.telemetry.summarize import main

if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
