"""Config module for --arch moonshot-v1-16b-a3b (see archs.py)."""
from .archs import moonshot_v1_16b_a3b as build

CONFIG = build()
