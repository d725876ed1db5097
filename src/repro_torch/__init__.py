"""repro_torch — the PyTorch / CUDA port of ``repro`` (Rapid Approximate
Aggregation with Distribution-Sensitive Interval Guarantees, Macke et
al., 2020) for NVIDIA Hopper cards.

The JAX package ``repro`` is the reference; this package keeps its
layout (``core/``, ``aqp/``, ``kernels/``, ``data/``) and its names, and
imports nothing of it. Entry points run on the card (``device="cuda"``)
unless the caller asks for ``device="cpu"``."""

__version__ = "0.1.0"
