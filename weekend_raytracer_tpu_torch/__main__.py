"""``python -m weekend_raytracer_tpu_torch`` runs the headless render CLI."""
import sys

from .cli import main

sys.exit(main())
