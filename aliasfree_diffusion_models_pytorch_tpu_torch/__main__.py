"""``python -m aliasfree_diffusion_models_pytorch_tpu_torch`` → the CLI."""

import sys

from aliasfree_diffusion_models_pytorch_tpu_torch.cli import main

sys.exit(main())
