"""CLI entry: ``python -m repro_torch.obs --validate run.trace.json``.

Delegates to :func:`repro_torch.obs.export.main` (also reachable as
``python -m repro_torch.obs.export``, modulo a harmless runpy warning).
"""
import sys

from repro_torch.obs.export import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
