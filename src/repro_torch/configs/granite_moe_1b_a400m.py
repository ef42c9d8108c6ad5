"""Config module for --arch granite-moe-1b-a400m (see archs.py)."""
from .archs import granite_moe_1b_a400m as build

CONFIG = build()
