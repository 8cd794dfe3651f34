"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each kernel module binds one CUDA source of `csrc/` and counts its
launches; `ops` dispatches on the device of the tensors it is given.
Nothing is compiled at import: `_build.extension()` builds the sources on
first use.
"""
