"""`python -m spark_tpu_torch.analysis.lints --all [--json]`: run the
port's source lints (see the package docstring)."""

import sys

from . import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
