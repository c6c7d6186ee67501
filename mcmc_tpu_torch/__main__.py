"""``python -m mcmc_tpu_torch <config>`` — see mcmc_tpu_torch.cli."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
