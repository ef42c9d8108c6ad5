"""Config module for --arch rwkv6-3b (see archs.py)."""
from .archs import rwkv6_3b as build

CONFIG = build()
