"""``python -m k8s_operator_libs_tpu_torch.train``: the training CLI."""

import sys

from .cli import main

sys.exit(main())
