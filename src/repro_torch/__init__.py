"""PyTorch / CUDA port of the StreamBrain reproduction (``repro``).

Mirrors ``repro``'s layout and names module for module.  On a CUDA device of
compute capability 9.0 or above every hot op runs as a hand-written Hopper
kernel (``repro_torch.kernels``); on the CPU the same code runs the kernels'
plain versions.  The package imports ``torch`` and ``numpy``, never JAX and
nothing of ``repro``.
"""
