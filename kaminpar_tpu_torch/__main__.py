"""Entry point: python -m kaminpar_tpu_torch <graph> -k <k> [options]."""

import sys

from .cli import main

sys.exit(main())
