"""Device/mesh capability probe CLI — the analogue of the
reference's `check_cooperative_groups.cu:4-48` (which enumerates CUDA
devices and reports cooperative-launch capability):

    python -m mpf_tpu.cli.probe [--json]
"""

from __future__ import annotations

import json
import sys



def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    from mpf_tpu.parallel.mesh import device_report

    report = device_report(verbose="--json" not in argv)
    if "--json" in argv:
        print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
