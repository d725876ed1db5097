"""repro_torch.distributed — the port of :mod:`repro.distributed`: the
straggler monitor (:mod:`~repro_torch.distributed.straggler`), the
trainer's checkpoints (:mod:`~repro_torch.distributed.checkpoint`) and
int8 gradient compression
(:mod:`~repro_torch.distributed.grad_compression`). The sharded scan's
layout lives in :mod:`repro_torch.aqp.distributed`, as the reference's
does in :mod:`repro.aqp.distributed`; parameter sharding
(``sharding.py``, ``axisctx.py``) is the next slice."""
