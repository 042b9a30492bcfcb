"""Source-port allocation for RoCEv2 queue pairs (ScaleAcross §3.3).

Implements both allocators studied in the paper:

* :func:`rxe_baseline_port` — the stock Soft-RoCE (``rdma-rxe``) behaviour:
  the 32-bit QP number is hashed with the Linux kernel's multiplicative
  ``hash_32`` into a 14-bit offset above the RoCEv2 base port 49192.

* :func:`qp_aware_port` — the paper's Algorithm 1 ("Queue-Pair-Aware Source
  Port Allocation"): the 16384-offset dynamic range is partitioned into
  ``k`` non-overlapping bins of width ``W_b = floor(16384/k)``; a QP is
  deterministically assigned bin ``B_i = I_QP mod k`` and the original hash
  is preserved *within* the bin via ``o_b = o_r mod W_b``.

The two-stage design guarantees that any ``k`` QPs with consecutive indices
occupy pairwise-distinct port sub-ranges, so correlated QP numbers can no
longer produce identical packet 5-tuples — the production pathology reported
by Gangidi et al. (SIGCOMM'24) and reproduced here in
``tests/test_ports.py::test_baseline_aliasing_stride``.
"""

from __future__ import annotations

import math

from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence

# RoCEv2 dynamic source-port range used by Soft-RoCE (paper §3.3).
ROCE_V2_BASE_PORT = 49192
PORT_OFFSET_BITS = 14
NUM_PORT_OFFSETS = 1 << PORT_OFFSET_BITS  # 16384
MAX_PORT = ROCE_V2_BASE_PORT + NUM_PORT_OFFSETS - 1  # 65535

# Linux kernel GOLDEN_RATIO_32 (include/linux/hash.h) used by hash_32().
_GOLDEN_RATIO_32 = 0x61C88647
_U32 = 0xFFFFFFFF


def hash_32(val: int, bits: int) -> int:
    """The Linux kernel's multiplicative hash: top ``bits`` of val*phi32."""
    return ((val * _GOLDEN_RATIO_32) & _U32) >> (32 - bits)


def rxe_baseline_port(qp_number: int) -> int:
    """Stock rdma-rxe source port: base + hash_32(qp_num, 14)."""
    return ROCE_V2_BASE_PORT + hash_32(qp_number & _U32, PORT_OFFSET_BITS)


@dataclass(frozen=True)
class QueuePair:
    """A queue pair as seen by the allocator.

    ``index`` is the QP's ordinal within its connection group (NCCL channel
    id); ``number`` is the driver-assigned 32-bit QP number, which in
    production may be correlated across QPs of the same GPU pair.
    """

    index: int
    number: int


def qp_aware_port(qp: QueuePair, k: int = 4) -> int:
    """Algorithm 1 from the paper, line for line.

    1. ``P_base = 49192``; bin width ``W_b = floor(16384 / k)``.
    2. ``o_r = Hash32(QP.number, 14)`` (unchanged Soft-RoCE hash).
    3. ``B_i = I_QP mod k`` (deterministic bin from the QP *index*).
    4. ``o_b = o_r mod W_b`` (hash constrained to the bin).
    5. ``P_s = P_base + B_i * W_b + o_b``.
    """
    if k < 1:
        raise ValueError(f"bin count k must be >= 1, got {k}")
    w_b = NUM_PORT_OFFSETS // k
    o_r = hash_32(qp.number & _U32, PORT_OFFSET_BITS)
    b_i = qp.index % k
    o_b = o_r % w_b
    return ROCE_V2_BASE_PORT + b_i * w_b + o_b


def baseline_ports(qps: Iterable[QueuePair]) -> List[int]:
    return [rxe_baseline_port(qp.number) for qp in qps]


def qp_aware_ports(qps: Iterable[QueuePair], k: int = 4) -> List[int]:
    return [qp_aware_port(qp, k=k) for qp in qps]


# ---------------------------------------------------------------------------
# QP-number allocation models (how drivers hand out qp numbers in practice).
# ---------------------------------------------------------------------------

#: Stride for which hash_32 provably aliases: 75025 = F(25), a Fibonacci
#: number, makes ``d * GOLDEN_RATIO_32 mod 2^32`` = 11703 — far below the
#: 2^18 bucket width of the 14-bit extraction — so runs of ~22 consecutive
#: QP numbers spaced by it receive *identical* 14-bit port offsets from
#: hash_32 (verified in tests/test_ports.py).  This is the concrete form of
#: the "different QPs receive identical source ports" production scenario
#: cited in §3.3 of the paper (Gangidi et al. observed it at Meta scale).
ALIASING_STRIDE = 75025
#: An even stronger alias (offsets identical for 40+ consecutive QPs).
ALIASING_STRIDE_STRONG = 328757


def make_queue_pairs(
    num_qps: int,
    *,
    base_number: int = 0x11,
    stride: int = 1,
) -> List[QueuePair]:
    """QPs with indices 0..n-1 and driver numbers base + i*stride."""
    return [QueuePair(index=i, number=(base_number + i * stride) & _U32) for i in range(num_qps)]


def make_correlated_queue_pairs(
    num_qps: int,
    *,
    base_number: int = 0x11,
    distinct_offsets: Optional[int] = None,
) -> List[QueuePair]:
    """QP numbers with the *partial* port aliasing seen in production.

    The §3.3 pathology in its realistic form: an n-QP connection set maps
    onto only ``u`` distinct hash_32 offsets (u grows with n — more
    channels add natural entropy, which is why the paper's gains shrink at
    32 QPs).  Constructed as ``base + (i mod u)*17 + (i div u)*S`` with S
    the strong aliasing stride, so QPs sharing ``i mod u`` share a source
    port under the default allocator, while Algorithm 1's index-keyed bins
    still separate them.
    """
    if distinct_offsets is None:
        u = math.isqrt(2 * num_qps)
        u += 1 - (u % 2)  # odd: avoids artificial resonance with k=4 bins
        u = max(3, u)
    else:
        u = distinct_offsets
    return [
        QueuePair(
            index=i,
            number=(base_number + (i % u) * 17 + (i // u) * ALIASING_STRIDE_STRONG) & _U32,
        )
        for i in range(num_qps)
    ]


def allocate_ports(
    qps: Sequence[QueuePair],
    *,
    scheme: str = "qp_aware",
    k: int = 4,
) -> List[int]:
    """Dispatch on allocation scheme name ("baseline" | "qp_aware")."""
    if scheme == "baseline":
        return baseline_ports(qps)
    if scheme == "qp_aware":
        return qp_aware_ports(qps, k=k)
    raise ValueError(f"unknown port allocation scheme: {scheme!r}")
