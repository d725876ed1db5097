"""repro_torch — the PyTorch / CUDA port of ``repro`` (Rapid Approximate
Aggregation with Distribution-Sensitive Interval Guarantees, Macke et
al., 2020) for NVIDIA Hopper cards.

The JAX package ``repro`` is the reference; this package keeps its
layout (``core/``, ``aqp/``, ``kernels/``, ``data/``, ``serve/``, for
the model zoo's Mamba1 serving and training paths ``configs/``,
``models/`` and ``train/``, the CI machinery's other consumers
``evalx/`` and ``distributed/straggler.py``, and the test-only fault
injection ``testing/``) and its names,
and imports nothing of it. Entry points run on the card
(``device="cuda"``) unless the caller asks for ``device="cpu"``
(:func:`repro_torch.device.resolve_device`)."""

__version__ = "0.1.0"
