"""repro_torch.data — the synthetic FLIGHTS generator (a numpy copy of
:mod:`repro.data.flights`) and the synthetic LM training batches and
scrambled eval sets (of :mod:`repro.data.tokens`)."""
