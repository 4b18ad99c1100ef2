"""fluctus_tpu_torch — the PyTorch/CUDA port of the wavefront path tracer.

Mirrors the layout of ``fluctus_tpu`` (the JAX reference package) module for
module, so every counterpart is easy to find. Plain tensor code is PyTorch;
every kernel that the reference wrote in Pallas is a hand-written CUDA C++
kernel for Hopper (``csrc/*.cu``), built at first use by
``kernel_build`` and bound with ``ctypes``. Each kernel wrapper keeps a
plain PyTorch version of the same function beside it, taken only for CPU
tensors (the CPU tests); on a CUDA tensor the wrapper launches the kernel
or raises.

This package imports ``torch`` and ``numpy`` only — never ``jax`` or
``fluctus_tpu``.
"""
