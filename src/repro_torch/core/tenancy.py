"""Multi-tenancy via VXLAN VNIs (paper §2.4, §5.4, Table 1).

Each training job is assigned a VNI; hosts attach to exactly one VNI.  The
EVPN RT import policy already guarantees control-plane isolation; this
module adds the job-level registry, attachment workflow, and the
reachability matrix the paper reports in Table 1.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

from .evpn import EvpnControlPlane
from .fabric import Fabric, UnreachableError


@dataclass
class Tenant:
    name: str
    vni: int
    hosts: List[str] = field(default_factory=list)


class TenancyManager:
    """VNI registry + host attachment over fabric/EVPN."""

    def __init__(self, fabric: Fabric, evpn: EvpnControlPlane):
        self.fabric = fabric
        self.evpn = evpn
        self.tenants: Dict[str, Tenant] = {}
        self._vni_to_tenant: Dict[int, str] = {}

    def create_tenant(self, name: str, vni: int) -> Tenant:
        if vni in self._vni_to_tenant:
            raise ValueError(f"VNI {vni} already assigned to {self._vni_to_tenant[vni]}")
        if not (1 <= vni <= (1 << 24) - 1):
            raise ValueError("VNI must fit in 24 bits")  # 16M VNIs vs 4096 VLANs (§3.1)
        tenant = Tenant(name=name, vni=vni)
        self.tenants[name] = tenant
        self._vni_to_tenant[vni] = name
        return tenant

    def attach(self, tenant_name: str, host: str) -> None:
        tenant = self.tenants[tenant_name]
        h = self.fabric.hosts[host]
        if h.vni is not None and h.vni != tenant.vni:
            raise ValueError(f"{host} already attached to VNI {h.vni}")
        self.evpn.learn_host(host, tenant.vni)
        if host not in tenant.hosts:
            tenant.hosts.append(host)

    def detach(self, tenant_name: str, host: str) -> None:
        """Detach ``host`` from its tenant (the churn counterpart of
        :meth:`attach`): its Type-2 routes are withdrawn fabric-wide and
        its VNI binding cleared, so both directions go unreachable."""
        tenant = self.tenants[tenant_name]
        if host not in tenant.hosts:
            raise ValueError(f"{host} is not attached to tenant {tenant_name!r}")
        self.evpn.withdraw_host(host)
        tenant.hosts.remove(host)

    def reachable(self, src: str, dst: str) -> bool:
        return self.evpn.reachable(src, dst)

    def ping(self, src: str, dst: str, nbytes: int = 64) -> bool:
        """Data-plane reachability probe (Table 1 semantics)."""
        try:
            self.fabric.send(src, dst, nbytes, src_port=49192, check_reachability=self.reachable)
            return True
        except UnreachableError:
            return False

    def isolation_matrix(self, hosts: Sequence[str]) -> Dict[Tuple[str, str], bool]:
        """Full pairwise reachability matrix for Table 1 reproduction."""
        out: Dict[Tuple[str, str], bool] = {}
        for a in hosts:
            for b in hosts:
                if a != b:
                    out[(a, b)] = self.reachable(a, b)
        return out

    def verify_isolation(self) -> None:
        """Assert the Table-1 invariant across all tenants.

        Intra-tenant pairs must be reachable; inter-tenant pairs must not.
        Raises AssertionError with the offending pair otherwise.
        """
        for ta in self.tenants.values():
            for tb in self.tenants.values():
                for ha in ta.hosts:
                    for hb in tb.hosts:
                        if ha == hb:
                            continue
                        want = ta.vni == tb.vni
                        got = self.reachable(ha, hb)
                        assert got == want, (
                            f"isolation violation: {ha}(vni={ta.vni}) -> "
                            f"{hb}(vni={tb.vni}) reachable={got}, want {want}"
                        )
