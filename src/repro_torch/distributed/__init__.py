"""repro_torch.distributed — the port of :mod:`repro.distributed`: so far
the straggler monitor (:mod:`repro_torch.distributed.straggler`). The
sharded scan's layout lives in :mod:`repro_torch.aqp.distributed`, as
the reference's does in :mod:`repro.aqp.distributed`; the distributed
checkpoint is a later slice."""
