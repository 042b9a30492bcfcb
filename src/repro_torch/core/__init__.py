"""The emulated EVPN-VXLAN geo fabric that prices each step's WAN sync.

Verbatim copies of the numpy modules of ``repro.core`` that
``GeoFabric`` imports (fabric, evpn, bfd, ports, flows, metrics, tenancy,
congestion, wan, schedule, geo): the port imports nothing of the JAX
package, not even its numpy-only modules.  Their imports are relative, so
each file is byte for byte its original, and a test holds it so.  No
torch here: the cost model runs on the host.
"""

from .bfd import BfdSession, BfdState
from .geo import GeoFabric, SyncCost, SyncOptions

__all__ = ["BfdSession", "BfdState", "GeoFabric", "SyncCost", "SyncOptions"]
