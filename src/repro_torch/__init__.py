"""repro_torch — the PyTorch/CUDA port of the ExpertMatcher serving system.

A package beside the JAX reference (``src/repro``) with the same layout
(``configs``, ``core``, ``data``, ``kernels``, ``launch``, ``models``,
``obs``, ``optim``, ``serve``, ``train``) and
the same public layouts, so each module is tested against its reference
counterpart on the same weights and inputs. It imports torch, numpy and
the standard library only.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on the CPU every hand-written kernel's wrapper takes its plain PyTorch
version, on a CUDA tensor it launches the kernel (built with ``nvcc`` at
first use, see ``kernels/build.py``).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
