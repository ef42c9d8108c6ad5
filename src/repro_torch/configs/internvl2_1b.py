"""Config module for --arch internvl2-1b (see archs.py)."""
from .archs import internvl2_1b as build

CONFIG = build()
