"""repro_torch.serve — the query serving layer, on the card.

The port of :mod:`repro.serve`. :class:`FrameServer` plans batches of
concurrent aggregate queries over one :class:`~repro_torch.aqp.engine.
FastFrame` into shared fused-scan passes; :class:`SharedPass` exposes
the incremental admit/step/retire/finish lifecycle underneath, and
:class:`QueryScheduler` turns it into a continuous-batching serving loop
with simulated or wall clocks, checkpointed fault recovery and a sound
degradation ladder (see :mod:`repro_torch.serve.frame_server`,
:mod:`repro_torch.serve.scheduler` and
:mod:`repro_torch.serve.checkpoint`).
"""

from repro_torch.serve.checkpoint import PassCheckpoint, SlotCheckpoint
from repro_torch.serve.frame_server import (FrameServer, SharedPass,
                                            UnsupportedPassConfig)
from repro_torch.serve.scheduler import (AdmissionQuote, QueryScheduler,
                                         QueryTicket, SimClock, WallClock)

__all__ = ["FrameServer", "SharedPass", "QueryScheduler", "QueryTicket",
           "AdmissionQuote", "SimClock", "WallClock", "PassCheckpoint",
           "SlotCheckpoint", "UnsupportedPassConfig"]
