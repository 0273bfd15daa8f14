# Device executors of the frontier MJoin on torch tensors: the resident-RIG
# packing (device_graph) and the slab / resident executors (frontier).  The
# process-wide device pin lives in ``frontier`` (DEFAULT_DEVICE): set it on
# that module.
from .device_graph import pack_resident_rig
from .frontier import (DeviceIntersector, ResidentIntersector,
                       resident_fingerprint, resolve)

__all__ = ["pack_resident_rig", "DeviceIntersector", "ResidentIntersector",
           "resident_fingerprint", "resolve"]
