"""Storage-device timing models for the simulated clock.

The same analytical model as the reference package, with the same constants,
so both packages bill a read identically. Device *timings* come from the
model (Samsung PM983 PCIe3 SSD, DDR4 DRAM, the paper's hardware); data
movement is real (numpy blob + thread pool).

Model for a batched random read of ``n`` blocks at queue depth ``qd``::

    t = base_latency + max(n / eff_iops, n * block / seq_bw)

``eff_iops`` saturates with queue depth (NVMe internal parallelism): at qd=1
an SSD delivers ~1/latency IOPS; at qd>=32 it reaches the datasheet number.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

#: The device I/O block (and layout alignment) size.
DEFAULT_BLOCK = 4096


@dataclass(frozen=True)
class StorageSpec:
    name: str
    base_latency_s: float         # fixed per-batch submission+completion cost
    device_latency_s: float       # per-IO device latency (qd=1 limit)
    rand_iops: float              # saturated 4K random IOPS
    seq_bw: float                 # bytes/s sequential/large-block bandwidth
    block: int = DEFAULT_BLOCK

    def eff_iops(self, qd: int) -> float:
        qd1 = 1.0 / self.device_latency_s
        return min(self.rand_iops, qd1 * max(1, qd))

    def read_time(self, n_blocks: int, qd: int = 64) -> float:
        if n_blocks <= 0:
            return 0.0
        iops_t = n_blocks / self.eff_iops(qd)
        bw_t = n_blocks * self.block / self.seq_bw
        return self.base_latency_s + max(iops_t, bw_t)

    def scaled(self, **kw) -> "StorageSpec":
        return replace(self, **kw)

    def raid0(self, n_drives: int) -> "StorageSpec":
        """Paper §7: GDS RAID-0 across drives multiplies random IOPS and
        bandwidth; n independent device queues also multiply the aggregate
        service rate (modelled as device_latency/n). The per-batch latency
        floor (base_latency) is unchanged."""
        return replace(self, name=f"{self.name}-raid0x{n_drives}",
                       rand_iops=self.rand_iops * n_drives,
                       seq_bw=self.seq_bw * n_drives,
                       device_latency_s=self.device_latency_s / n_drives)


# PM983 (paper's SSD): PCIe3 x4, ~3.0 GB/s seq read, ~540K 4K IOPS, ~90us lat.
PM983_PCIE3 = StorageSpec("pm983-pcie3", 20e-6, 90e-6, 540_000, 3.0e9)
# PCIe4-class drive: the paper projects 2x random bandwidth -> threshold 24.
PM9A3_PCIE4 = StorageSpec("pm9a3-pcie4", 20e-6, 70e-6, 1_080_000, 6.2e9)
# DDR4 DRAM "device": gather-bound; 7.2x faster than GDS for the paper's
# 1000-doc working set (calibration anchor, paper §5.4 / Fig 8).
DRAM = StorageSpec("ddr4-dram", 2e-6, 0.1e-6, 30_000_000, 18e9)

# software-stack overheads (per Crotty et al. and the paper's §2.3/§5.3)
MMAP_FAULT_OVERHEAD_S = 18e-6     # page-fault + kernel mapping per missed page
MMAP_QD = 1                       # blocking fault handling: no queue parallelism
SWAP_PAGES_PER_FAULT = 8          # "the OS brings in 8 pages per page fault"
SWAP_FAULT_OVERHEAD_S = 14e-6


def mmap_read_time(spec: StorageSpec, n_pages: int, hit_rate: float) -> float:
    """Blocking page-fault reads: misses pay fault overhead + qd=1 device IO."""
    misses = n_pages * (1.0 - hit_rate)
    dev = spec.scaled(base_latency_s=0.0).read_time(1, qd=MMAP_QD)
    return misses * (MMAP_FAULT_OVERHEAD_S + dev) + n_pages * 0.05e-6


def swap_read_time(spec: StorageSpec, n_pages: int, hit_rate: float) -> float:
    """Swap-space faults bring SWAP_PAGES_PER_FAULT pages per fault."""
    misses = n_pages * (1.0 - hit_rate)
    faults = misses / SWAP_PAGES_PER_FAULT
    dev = spec.scaled(base_latency_s=0.0).read_time(SWAP_PAGES_PER_FAULT, qd=4)
    return faults * (SWAP_FAULT_OVERHEAD_S + dev) + n_pages * 0.05e-6


def h2d_time(n_bytes: int, pcie_bw: float = 12e9, base_s: float = 8e-6) -> float:
    """Host->device transfer on the simulated clock: the extra hop a
    storage read pays before the rerank can use the rows. The bandwidth and
    floor are the simulation's parameters, kept equal to the reference's."""
    return base_s + n_bytes / pcie_bw
