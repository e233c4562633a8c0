import sys

from tpu_hpc_torch.serve.server import main

if __name__ == "__main__":
    sys.exit(main())
