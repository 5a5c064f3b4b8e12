import sys

from dmlp_tpu_torch.cli import main

sys.exit(main())
