"""portbench.control with the routed experts' faults (portbench.faults_moe)
beside the serving faults:

    python3 -m portbench.control_moe --workload CELL --seeds 11,12,13 [--fault top7]"""

from __future__ import annotations

import sys

from portbench import control, faults, faults_moe


def main(argv=None) -> int:
    faults.SERVING.update(faults_moe.SERVING)
    return control.main(argv)


if __name__ == "__main__":
    sys.exit(main())
