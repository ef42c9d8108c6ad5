"""Config module for --arch starcoder2-3b (see archs.py)."""
from .archs import starcoder2_3b as build

CONFIG = build()
