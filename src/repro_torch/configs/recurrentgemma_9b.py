"""Config module for --arch recurrentgemma-9b (see archs.py)."""
from .archs import recurrentgemma_9b as build

CONFIG = build()
