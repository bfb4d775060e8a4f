import sys

from dgmc_tpu_torch.serve.cli import main

if __name__ == '__main__':
    sys.exit(main())
