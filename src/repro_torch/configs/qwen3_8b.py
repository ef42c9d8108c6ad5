"""Config module for --arch qwen3-8b (see archs.py)."""
from .archs import qwen3_8b as build

CONFIG = build()
