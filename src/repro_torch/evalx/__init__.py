"""repro_torch.evalx — the paper's technique as a first-class framework
feature, the port of :mod:`repro.evalx`: CI-guaranteed early-stopped
evaluation and threshold monitors."""

from repro_torch.evalx.approx_eval import ApproxEval, EvalReport
from repro_torch.evalx.monitors import ThresholdMonitor

__all__ = ["ApproxEval", "EvalReport", "ThresholdMonitor"]
