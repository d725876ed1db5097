"""repro_torch.models — the model zoo's ported families (ssm / Mamba1,
dense, vlm with its frontend stubbed, MoE; the hybrid and enc-dec are
still to come), the port of :mod:`repro.models`."""

from repro_torch.models.zoo import (Model, TensorSpec, build, input_specs,
                                    make_batch, window_for)

__all__ = ["Model", "TensorSpec", "build", "input_specs", "make_batch",
           "window_for"]
