"""``python -m repro_torch.analysis`` — the port's palmlint gate."""
import sys

from .cli import main

sys.exit(main())
