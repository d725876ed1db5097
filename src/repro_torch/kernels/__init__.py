"""repro_torch.kernels — the hot paths on Hopper: hand-written CUDA
kernels (``csrc/``: the AQP scan's folds and probe, the Mamba1 selective
scan) behind :mod:`.ops`, their plain PyTorch versions in :mod:`.ref`,
and the fused scan round in :mod:`.fused_scan`. CUDA sources are
compiled at first use (:mod:`._build`), never at import."""
