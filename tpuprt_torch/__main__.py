"""``python -m tpuprt_torch scene.pbrt [-o out.exr] ...``: the command-line
renderer (cli.py)."""
import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
