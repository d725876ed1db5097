"""repro_torch.launch — entry points, the port of :mod:`repro.launch`: the
training driver (:mod:`repro_torch.launch.train`), the meshes
(:mod:`repro_torch.launch.mesh`) and the meta-device dry runs
(:mod:`repro_torch.launch.dryrun`, :mod:`repro_torch.launch.dryrun_aqp`).
The reference's ``hlo_cost.py``, which reads XLA's compiled HLO text, has
no counterpart: the dry run counts FLOPs with ``FlopCounterMode``."""
