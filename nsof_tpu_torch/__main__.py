"""``python -m nsof_tpu_torch <command>``: the port's command line
(:mod:`nsof_tpu_torch.cli`)."""

import sys

from nsof_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
