"""``python -m dgmc_tpu_torch.serve``: the serving worker."""

import sys

from dgmc_tpu_torch.serve.service import main

if __name__ == '__main__':
    sys.exit(main())
