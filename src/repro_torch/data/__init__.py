"""repro_torch.data — the synthetic FLIGHTS generator (a numpy copy of
:mod:`repro.data.flights`)."""
