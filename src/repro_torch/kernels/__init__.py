"""Hand-written Hopper (sm_90a) kernels of the port, with their plain
PyTorch versions; see ``ops`` for the entry points and ``build`` for how
the CUDA sources in ``csrc/`` are compiled at first use."""
