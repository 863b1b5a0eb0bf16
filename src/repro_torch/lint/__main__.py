"""``python -m repro_torch.lint`` entry point."""
import sys

from .cli import main

if __name__ == "__main__":  # importing the package's modules runs nothing
    sys.exit(main())
