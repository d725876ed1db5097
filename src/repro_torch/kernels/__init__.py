"""repro_torch.kernels — the scan hot path on Hopper: hand-written CUDA
kernels (``csrc/``) behind :mod:`.ops`, their plain PyTorch versions in
:mod:`.ref`, and the fused scan round in :mod:`.fused_scan`. CUDA sources
are compiled at first use (:mod:`._build`), never at import."""
