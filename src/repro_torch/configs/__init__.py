"""Architecture configs: ``FULL`` (published) and ``SMOKE`` (reduced, for
CPU tests) per arch, and the registry over them."""
from .base import ARCHS, ALIASES, SHAPES, ShapeSpec, get, cells

__all__ = ["ARCHS", "ALIASES", "SHAPES", "ShapeSpec", "cells", "get"]
