"""repro_torch.distributed — the port of :mod:`repro.distributed`: the
straggler monitor (:mod:`~repro_torch.distributed.straggler`), the
trainer's checkpoints with their placement on a mesh
(:mod:`~repro_torch.distributed.checkpoint`), int8 gradient compression
(:mod:`~repro_torch.distributed.grad_compression`), the sharding rules
(:mod:`~repro_torch.distributed.sharding`: parameter, optimizer, batch
and cache specs laid out as DTensors), the logical-axis constraints
(:mod:`~repro_torch.distributed.axisctx`) and the collectives of the
sharded train step (:mod:`~repro_torch.distributed.collectives`). The
sharded scan's layout lives in :mod:`repro_torch.aqp.distributed`, as the
reference's does in :mod:`repro.aqp.distributed`."""
