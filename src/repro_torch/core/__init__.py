"""repro_torch.core — the paper's contribution, host half: SSI bounders,
RangeTrim, OptStop, COUNT/SUM intervals and derived ranges, in float64
numpy (the port of the host paths of :mod:`repro.core`)."""
