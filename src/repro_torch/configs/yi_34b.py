"""Config module for --arch yi-34b (see archs.py)."""
from .archs import yi_34b as build

CONFIG = build()
