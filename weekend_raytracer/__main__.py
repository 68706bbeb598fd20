"""``python -m weekend_raytracer`` runs the headless render CLI."""
import sys

from .cli import main

sys.exit(main())
