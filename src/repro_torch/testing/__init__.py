"""repro_torch.testing — deterministic test harnesses (fault injection),
the port of :mod:`repro.testing`.

Nothing under this package may be imported from production modules of
``repro_torch`` (``tests/test_torch_isolation.py`` checks it, the port's
counterpart of aqplint's AQP104). The scheduler consumes a
:class:`~repro_torch.testing.faults.FaultInjector` as an opaque
``fault_hook`` object, so serving code never names this package.
"""

from repro_torch.testing.faults import (DeviceOOMHook, FaultEvent,
                                        FaultInjector,
                                        InjectedDispatchError, InjectedFault,
                                        InjectedOOM, InjectedShardDropout,
                                        InjectedTransferError, fault_schedule)

__all__ = ["DeviceOOMHook", "FaultEvent", "FaultInjector", "InjectedFault",
           "InjectedDispatchError", "InjectedOOM",
           "InjectedShardDropout", "InjectedTransferError",
           "fault_schedule"]
