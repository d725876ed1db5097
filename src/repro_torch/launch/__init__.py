"""repro_torch.launch — entry points, the port of :mod:`repro.launch`: the
training driver (:mod:`repro_torch.launch.train`), the meshes
(:mod:`repro_torch.launch.mesh`), the meta-device dry runs
(:mod:`repro_torch.launch.dryrun`, :mod:`repro_torch.launch.dryrun_aqp`)
and the cost of one step that they record
(:mod:`repro_torch.launch.step_cost`, the counterpart of the reference's
``hlo_cost.py``: FLOPs, bytes, collectives by kind and peak memory from
the ATen ops that the step dispatches)."""
