"""Config module for --arch gemma3-27b (see archs.py)."""
from .archs import gemma3_27b as build

CONFIG = build()
