"""repro_torch.launch — entry points, the port of :mod:`repro.launch`: so
far the training driver (:mod:`repro_torch.launch.train`). The mesh
definitions and the meta-device dry runs are the next slice."""
