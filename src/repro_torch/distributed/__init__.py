"""repro_torch.distributed — the port of :mod:`repro.distributed`: so far
the straggler monitor (:mod:`repro_torch.distributed.straggler`). The
sharded scan and the distributed checkpoint are later slices."""
