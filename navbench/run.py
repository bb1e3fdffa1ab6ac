"""``python3 -m navbench.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell (``harness.main``)."""

import sys

from navbench.harness import main

if __name__ == "__main__":
    sys.exit(main())
