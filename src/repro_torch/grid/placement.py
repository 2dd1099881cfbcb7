"""Map a device mesh onto the paper's grid topology (the counterpart of
``repro.grid.placement``).

Pods (the slow-interconnect level) become regions; hosts become sites,
as in the reference. Every figure is a parameter whose default is the
H100 node's (:mod:`repro_torch.launch.roofline`):

  * a site's compute: ``gpus_per_host`` x the dense bf16 peak of one H100
    SXM (989 TFLOP/s, datasheet);
  * a site's LAN link: the host's InfiniBand, one ConnectX-7 NDR port
    (400 Gb/s = 50 GB/s) a GPU, ``gpus_per_host`` of them. NVLink (450
    GB/s a GPU each way) joins the GPUs inside a host, which is one site,
    so it is no grid link;
  * the WAN (cross-pod) link: an assumption, not a datasheet figure: one
    NDR port's 50 GB/s a host between pods, an eighth of a host's own
    InfiniBand, so the cross-pod level stays the grid's slow one;
  * a site's storage: a DGX H100's 2 TB of host memory.
"""

from __future__ import annotations

import math

from ..core.topology import GridTopology
from ..launch.roofline import BF16_FLOPS, GPUS_PER_NODE, IB_BW

#: cross-pod bytes/s a host: an assumption (module docstring)
CROSS_POD_BW = 50e9
#: host memory tier for data artifacts (DGX H100: 2 TB)
HOST_STORAGE = 2e12


def mesh_to_topology(mesh, *, gpus_per_host: int = GPUS_PER_NODE,
                     host_storage: float = HOST_STORAGE,
                     gpu_flops: float = BF16_FLOPS,
                     lan_bandwidth: float | None = None,
                     wan_bandwidth: float = CROSS_POD_BW) -> GridTopology:
    """The two-level grid of a ("pod", ...) or (...) mesh (a DeviceMesh, or
    anything with ``mesh_dim_names`` and ``shape``): one region a pod, one
    site a host of ``gpus_per_host`` GPUs. ``lan_bandwidth`` defaults to
    the host's InfiniBand, ``gpus_per_host`` x 50 GB/s."""
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    n_pods = sizes.get("pod", 1)
    gpus = math.prod(tuple(mesh.shape)) // n_pods
    hosts_per_pod = max(1, gpus // gpus_per_host)
    if lan_bandwidth is None:
        lan_bandwidth = IB_BW * gpus_per_host
    return GridTopology(
        n_regions=n_pods,
        sites_per_region=hosts_per_pod,
        lan_bandwidth=lan_bandwidth,
        wan_bandwidth=wan_bandwidth,
        storage_capacity=host_storage,
        compute_capacities=[gpu_flops * gpus_per_host],
    )


def host_of_device(device_index: int,
                   gpus_per_host: int = GPUS_PER_NODE) -> int:
    return device_index // gpus_per_host
