"""PyTorch/CUDA port of the semantic-operator system in ``repro``.

``repro_torch.X.Y`` mirrors ``repro.X.Y``.  The kernels (``similarity``,
``cluster_scan``, ``cluster_scan_q`` for retrieval; ``flash_attention``,
``rmsnorm`` and ``decode_attention`` for the LLM) are CUDA C++ for Hopper
under ``kernels/csrc/``, built at first use.  Entry points run on CUDA unless
``set_device("cpu")`` asks for the CPU.
"""
from repro_torch.device import current_device, set_device

__all__ = ["current_device", "set_device"]
