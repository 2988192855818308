"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version.  Sources live in ``csrc/`` and build at first use
(``_build.py``); nothing is compiled or loaded at import time."""
