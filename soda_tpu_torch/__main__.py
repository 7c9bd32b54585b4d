"""`python -m soda_tpu_torch` = the port's command line (sodac.py)."""

import sys

from soda_tpu_torch.sodac import main

if __name__ == '__main__':
  sys.exit(main())
