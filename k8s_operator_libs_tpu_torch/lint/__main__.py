"""`python -m k8s_operator_libs_tpu_torch.lint` entry point (see the
package docstring for flags)."""

import sys

from . import main

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
