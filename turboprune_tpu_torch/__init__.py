"""TurboPrune on PyTorch and CUDA: the port of ``turboprune_tpu`` to an
NVIDIA H100.

Mirrors the JAX package's layout (``config/``, ``ops/``, ``models/``,
``serve/``, ``utils/``) and imports nothing from it. The JAX package stays
the reference; ``tests/test_torch_*.py`` hold each module against its JAX
counterpart on the CPU, and ``chip_smoke.py`` drives the port on the card.
"""
