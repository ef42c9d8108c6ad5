"""Config module for --arch seamless-m4t-large-v2 (see archs.py)."""
from .archs import seamless_m4t_large_v2 as build

CONFIG = build()
