"""One run of a callable under ``torch.profiler``: device busy share, top ops."""

from __future__ import annotations

import time


def profile_run(label, fn, device, rows: int = 12) -> None:
    """Run ``fn`` once to warm, then once under the profiler; print the
    device's busy share of the wall time and the ops by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    print(
        f"profile {label}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), {len(kernels)} device events"
    )
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=rows))
