"""repro_torch.models — the model zoo's families (ssm / Mamba1, dense,
vlm with its frontend stubbed, MoE, the hybrid Mamba2 / shared-attention
zamba2, the enc-dec seamless with its audio frontend stubbed), the port
of :mod:`repro.models`."""

from repro_torch.models.zoo import (Model, TensorSpec, build, input_specs,
                                    make_batch, window_for)

__all__ = ["Model", "TensorSpec", "build", "input_specs", "make_batch",
           "window_for"]
