# The port's device layer.  The whole-graph matcher: the packed data graph
# on the card (device_graph), query tensors and the JO order (encoding),
# the batched double simulation on the bitmm kernel (simulation), the
# fixed-capacity frontier MJoin (enumerate) and TorchGM (matcher).  The
# executors of the host-driven MJoin: the resident-RIG packing
# (device_graph) and the slab / resident executors (frontier).  The
# process-wide device pin lives in ``frontier`` (DEFAULT_DEVICE): set it on
# that module.  The sharded simulation and serve step over a
# ``torch.distributed`` mesh are in ``distributed``, which callers import
# themselves (it is not re-exported here).
from .device_graph import (DeviceGraph, from_host, pack_resident_rig,
                           stacked_matrices)
from .encoding import QueryTensor, encode_batch, encode_query, jo_order
from .enumerate import MJoinCount, decode_tuples, mjoin_count
from .frontier import (DeviceIntersector, ResidentIntersector,
                       resident_fingerprint, resolve)
from .matcher import TorchGM, TorchMatchResult
from .simulation import double_simulation, fb_sizes, rig_edge_counts

__all__ = [
    "DeviceGraph", "from_host", "stacked_matrices", "pack_resident_rig",
    "QueryTensor", "encode_query", "encode_batch", "jo_order",
    "double_simulation", "fb_sizes", "rig_edge_counts",
    "mjoin_count", "MJoinCount", "decode_tuples",
    "DeviceIntersector", "ResidentIntersector", "resident_fingerprint",
    "resolve", "TorchGM", "TorchMatchResult",
]
