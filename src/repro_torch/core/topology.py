"""Machine model for the k-lane / k-ported collective algorithm study.

The paper (Träff 2020) models a cluster of ``N`` compute nodes with ``n``
processor-cores each (``p = N*n`` processors, consecutive ranks, node-major:
rank ``i`` lives on node ``i // n``).  A node can drive ``k`` simultaneous
off-node messages ("k lanes"); a single processor can drive at most one.
Intra-node communication goes through shared memory.

We parameterize communication with a hierarchical alpha-beta model:

* ``alpha_intra`` / ``beta_intra``  — latency (us) / inverse bandwidth
  (us per element) for on-node (shared-memory) messages,
* ``alpha_inter`` / ``beta_inter``  — the same for off-node (network) messages,
* ``k_lanes``                       — number of network rails per node,
* ``node_bw_elems``                 — aggregate shared-memory elements/us cap
  (models the paper's open question about concurrent on-node bandwidth).

Three presets are shipped: ``HYDRA`` (calibrated against the paper's own
36x32-core dual-OmniPath measurements, Tables 2-7), ``TPU_V5E`` (a pod
viewed through the paper's glasses: "node" = pod, "lane" = concurrent
inter-pod DCN streams, on-node = intra-pod ICI), and ``NVLINK_IB``
(GPU/NCCL: "node" = 8-GPU NVSwitch box, "lane" = IB rail — the second
machine model for the schedule optimizer and selector).
"""

from __future__ import annotations

import dataclasses
import math

__all__ = [
    "Topology",
    "CostParams",
    "Machine",
    "HYDRA",
    "TPU_V5E",
    "NVLINK_IB",
    "hydra_machine",
    "tpu_v5e_machine",
    "nvlink_ib_machine",
]


@dataclasses.dataclass(frozen=True)
class Topology:
    """Static shape of the machine: N nodes x n procs, k lanes per node."""

    num_nodes: int  # N
    procs_per_node: int  # n
    k_lanes: int  # k

    def __post_init__(self):
        if self.num_nodes < 1 or self.procs_per_node < 1:
            raise ValueError("need at least one node and one proc per node")
        if self.k_lanes < 1:
            raise ValueError("k_lanes must be >= 1")
        if self.k_lanes > self.procs_per_node:
            # A lane is driven by a processor; more lanes than procs is
            # meaningless in the paper's model.
            raise ValueError("k_lanes cannot exceed procs_per_node")

    @property
    def p(self) -> int:
        return self.num_nodes * self.procs_per_node

    def node_of(self, rank: int) -> int:
        return rank // self.procs_per_node

    def local_rank(self, rank: int) -> int:
        return rank % self.procs_per_node

    def rank_of(self, node: int, local: int) -> int:
        return node * self.procs_per_node + local

    def same_node(self, a: int, b: int) -> bool:
        return self.node_of(a) == self.node_of(b)


@dataclasses.dataclass(frozen=True)
class CostParams:
    """Hierarchical alpha-beta parameters.  Times in microseconds, sizes in
    data elements (the paper uses MPI_INT = 4 bytes)."""

    alpha_intra: float  # us, per on-node message batch
    beta_intra: float  # us per element, on-node
    alpha_inter: float  # us, per off-node message batch
    beta_inter: float  # us per element through ONE lane
    node_bw_elems: float  # aggregate on-node elements/us (shared memory cap)
    elem_bytes: int = 4

    def intra_time(self, elems: int) -> float:
        return self.alpha_intra + self.beta_intra * elems

    def inter_time(self, elems: int) -> float:
        return self.alpha_inter + self.beta_inter * elems


@dataclasses.dataclass(frozen=True)
class Machine:
    topo: Topology
    cost: CostParams

    @property
    def p(self) -> int:
        return self.topo.p

    def degradation(self):
        """Per-node fault state for the simulator, or ``None`` when healthy.

        Healthy machines (this base class) always return ``None``, which
        keeps ``core.simulate``'s fast path bit-exact with the per-``Msg``
        reference.  ``core.faults.FaultedMachine`` overrides this with a
        :class:`~repro.core.faults.Degradation` (surviving lanes per node,
        derated link factors, dead ports/ranks) that the simulator prices
        through the same ``port_time``/``lane_time`` hooks.
        """
        return None


# ---------------------------------------------------------------------------
# Presets.
# ---------------------------------------------------------------------------

# Calibration notes (paper Tables 2-7, Open MPI numbers, times in us):
#  * inter-node ping (c=1):  ~ 10-16 us end to end      -> alpha_inter ~ 1.5
#    (schedules batch k sends under one software alpha).
#  * k-ported alltoall N=32, c=31250 ints: 31 blocks x 125 KB leave each node
#    in ~420 us  -> per-lane beta: dual OmniPath ~ 12.5 GB/s per rail
#    ~ 3.2e-4 us per 4-byte elem per lane.
#  * on-node alltoall 32 procs, c=31250: ~4400 us for 31x125KB per proc
#    -> shared memory is the bottleneck: aggregate ~ 27 GB/s
#    -> node_bw_elems ~ 6.9e3 elems/us; beta_intra per message ~ 1.2e-3.
HYDRA = Machine(
    topo=Topology(num_nodes=36, procs_per_node=32, k_lanes=2),
    cost=CostParams(
        alpha_intra=0.30,
        beta_intra=1.2e-3,
        alpha_inter=1.50,
        beta_inter=3.2e-4,
        node_bw_elems=6.9e3,
        elem_bytes=4,
    ),
)

# TPU v5e through the paper's glasses.  "node" = one 16x16 pod (256 chips),
# "lane" = a concurrent inter-pod DCN stream (k of them per pod), "on-node"
# = intra-pod ICI.  ICI: ~50 GB/s per link per chip propagates an aggregate
# on-"node" bandwidth far beyond shared memory; DCN per stream ~ 25 GB/s.
# Element size 2 (bf16).
TPU_V5E = Machine(
    topo=Topology(num_nodes=2, procs_per_node=256, k_lanes=8),
    cost=CostParams(
        alpha_intra=1.0,  # ICI collective hop latency, us
        beta_intra=4.0e-5,  # us/elem at 50 GB/s, bf16
        alpha_inter=10.0,  # DCN latency, us
        beta_inter=8.0e-5,  # us/elem at 25 GB/s per stream, bf16
        node_bw_elems=256 * 2.5e4 / 2,  # all chips stream ICI concurrently
        elem_bytes=2,
    ),
)


def hydra_machine(k_lanes: int | None = None) -> Machine:
    """Hydra with an overridden lane count (the paper sweeps k=1..6 as
    *virtual* lanes even though the hardware has 2 physical rails)."""
    if k_lanes is None:
        return HYDRA
    return Machine(
        topo=dataclasses.replace(HYDRA.topo, k_lanes=k_lanes), cost=HYDRA.cost
    )


def tpu_v5e_machine(num_pods: int = 2, k_lanes: int = 8) -> Machine:
    return Machine(
        topo=Topology(num_nodes=num_pods, procs_per_node=256, k_lanes=k_lanes),
        cost=TPU_V5E.cost,
    )


# GPU/NCCL cluster through the paper's glasses: "node" = one 8-GPU NVSwitch
# box, "proc" = a GPU, "lane" = an InfiniBand rail (rail-optimized fabrics
# ship 1..8 HCAs per node — exactly the paper's k).  Calibration against
# published NCCL curves: ~5 us small-message inter-node latency (NCCL
# LL/Simple protocol floor over IB), ~45 GB/s busbw per 400G rail at
# bandwidth saturation; intra-node NVSwitch ~ 3 us kernel/proxy latency and
# ~370 GB/s per-GPU NVLink bandwidth, with the switch fabric sustaining all
# 8 GPUs concurrently (aggregate ~ 2.9 TB/s).  Element size 4 (fp32 grads).
NVLINK_IB = Machine(
    topo=Topology(num_nodes=16, procs_per_node=8, k_lanes=4),
    cost=CostParams(
        alpha_intra=3.0,  # NVLink/NVSwitch path latency, us
        beta_intra=1.1e-5,  # us/elem at ~370 GB/s, fp32
        alpha_inter=5.0,  # IB + NCCL proxy latency, us
        beta_inter=8.9e-5,  # us/elem at ~45 GB/s per rail, fp32
        node_bw_elems=7.2e5,  # NVSwitch aggregate ~2.9 TB/s, elems/us
        elem_bytes=4,
    ),
)


def nvlink_ib_machine(
    k_rails: int = 4, num_nodes: int = 16, procs_per_node: int = 8
) -> Machine:
    """NVLink/IB preset with an overridden rail count — the second machine
    model for evaluating the optimizer and selector (lanes = IB rails per
    node, 1..procs_per_node)."""
    return Machine(
        topo=Topology(
            num_nodes=num_nodes,
            procs_per_node=procs_per_node,
            k_lanes=min(k_rails, procs_per_node),
        ),
        cost=NVLINK_IB.cost,
    )


def log_radix(p: int, radix: int) -> int:
    """ceil(log_{radix}(p)) — the round count of radix-(k+1) divide&conquer."""
    if p <= 1:
        return 0
    return int(math.ceil(math.log(p) / math.log(radix) - 1e-12))
