"""Where the port's entry points run: the card unless the caller asks for
the CPU, or for the ``meta`` device (shapes and dtypes only, no storage:
the dry runs of :mod:`repro_torch.launch.dryrun`). Shared by the query
engine (:mod:`repro_torch.aqp`) and the model zoo
(:mod:`repro_torch.models`)."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The entry point's device: ``None`` means the card (``"cuda"``).
    Raises when CUDA is asked for and absent — the port never falls back
    to the CPU silently; ``device="cpu"`` runs the plain PyTorch versions
    of the kernels, and ``device="meta"`` builds shape-only tensors (never
    chosen unless asked for)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the card by default, but CUDA is not "
                "available here. Pass device='cpu' to run with the plain "
                "PyTorch versions of its kernels on the host.")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev} (use 'cuda', 'cpu' or "
                         "'meta')")
    return dev
