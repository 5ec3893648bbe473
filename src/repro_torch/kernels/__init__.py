"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.

Every kernel wrapper dispatches on the device of the tensors it is given:
a CPU tensor takes the plain version (``ref.py``), a CUDA tensor launches
the kernel or raises. There is no fallback from a failed build or launch to
the plain version. Each wrapper counts its launches in ``<wrapper>.launches``.
"""
