"""Shared argument handling for the port's examples (not part of the library)."""

import argparse
import os
import sys

# Make the repo checkout importable no matter where the example is run
# from (the package also works pip-installed; then this is a no-op).
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def parse_args(description: str, **extra):
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the kernels' "
                        "plain twins on the host)")
    for name, kw in extra.items():
        p.add_argument(name, **kw)
    return p.parse_args()
