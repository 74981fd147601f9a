"""Device memory observability.

Counterpart of the memory half of photo_slam_tpu/utils/profiling.py
(reference: examples/replica_rgbd.cpp:235-249 GpuPeakUsageMB): the
caching allocator's statistics under the JAX package's key names. The span
timers and the trace context of that module are not ported yet.
"""
from __future__ import annotations

import torch


def device_memory_stats(device) -> dict:
    """bytes_in_use, peak_bytes_in_use and bytes_limit of a CUDA device (and
    each in MB under its *_mb name), from torch.cuda.memory_stats; {} for
    the CPU, which has no allocator statistics."""
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    raw = torch.cuda.memory_stats(device)
    stats = {
        "bytes_in_use": raw.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": raw.get("allocated_bytes.all.peak", 0),
        "bytes_limit": torch.cuda.get_device_properties(device).total_memory,
    }
    for key in list(stats):
        stats[key.replace("bytes", "mb")] = stats[key] / (1024 * 1024)
    return stats
