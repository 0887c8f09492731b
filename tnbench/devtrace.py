"""Reading a ``torch.profiler`` trace of the window: device time by kernel
family, the device's busy time, and where it waited.

``FAMILIES`` and ``family`` are copied from
``scripts/profile_torch_port.py`` at commit 20f345e (the port's own
profiler script), so that the yardstick stays put when the program's
copy changes.  The busy time differs from that script's on purpose: it is
the union of the device operations' intervals, not the sum of their
lengths, so that operations that overlap are counted once.
"""

from collections import defaultdict

FAMILIES = (   # (family, substrings of the kernel name), first match wins
    ("gatherk.cu (GGK stream)", ("ggk_stream_kernel",)),
    ("gatherk.cu (GGK mma)", ("ggk_wgmma_kernel", "ggk_mma_kernel")),
    ("gatherk.cu (GK stream)", ("gk_stream_kernel",)),
    ("gatherk.cu (GK mma)", ("gk_wgmma_kernel", "gk_mma_kernel")),
    ("pair.cu (Pair)", ("pair_wgmma_kernel", "pair_mma_kernel<false")),
    ("pair.cu (complex matmul)", ("cmm_wgmma_kernel", "cmm_kernel",
                                  "pair_mma_kernel<true")),
    ("rgrow.cu (RGRow)", ("rgrow_kernel",)),
    ("rgflat.cu (RGFlat)", ("rgflat_kernel",)),
    ("lane.cu (Lane)", ("lane_kernel",)),
    ("cuBLAS/CUTLASS matmul (dot fallback)",
     ("gemm", "cutlass", "cublas", "Kernel2")),
    ("PyTorch copies/permutes", ("copy", "Copy")),
    ("PyTorch index/gather", ("index", "gather", "Index")),
    ("PyTorch elementwise", ("elementwise", "vectorized")),
    ("PyTorch reductions", ("reduce", "Reduce")),
    ("memcpy/memset", ("Memcpy", "Memset", "memcpy", "memset")),
)

# the families whose kernels run on the tensor-core core (wgmma_core.cuh)
WGMMA = ("gatherk.cu (GGK mma)", "gatherk.cu (GK mma)", "pair.cu (Pair)",
         "pair.cu (complex matmul)")
DOT = ("cuBLAS/CUTLASS matmul (dot fallback)",)
COPIES = ("PyTorch copies/permutes",)

# host phases the harness marks with ``record_function``; an idle gap is
# named by the innermost one around its middle
HOST_MARK = "tnbench."
NAME_CHARS = 160


def family(name):
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other"


def union_seconds(intervals):
    """Length of the union of ``(start, end)`` intervals (any unit)."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def gaps(intervals):
    """``(start, end)`` of the idle stretches between the union's parts."""
    out, end = [], None
    for a, b in sorted(intervals):
        if end is not None and a > end:
            out.append((end, a))
        end = b if end is None else max(end, b)
    return out


def summarize(events, window_s, batches, top=10):
    """The trace of ``batches`` batches over ``window_s`` host seconds.

    ``events``: ``(name, start_us, end_us, on_device)`` tuples.  Returns
    None when no operation ran on the device, else ``busy_s`` (the union
    of the device intervals), ``window_s``, ``batches``, ``family_s``
    (device seconds by family, summed), ``device_ops`` (the ``top``
    operations by summed seconds) and ``idle_gaps`` (the ``top`` longest
    gaps between device operations, named by the host phase around them).
    """
    dev = [(n, a, b) for n, a, b, on in events if on and b > a]
    if not dev:
        return None
    host = [(n, a, b) for n, a, b, on in events
            if not on and n.startswith(HOST_MARK)]
    ivals = [(a, b) for _, a, b in dev]
    fam_s, op_s = defaultdict(float), defaultdict(float)
    for n, a, b in dev:
        fam_s[family(n)] += 1e-6 * (b - a)
        op_s[n[:NAME_CHARS]] += 1e-6 * (b - a)

    def host_phase(a, b):
        mid = 0.5 * (a + b)
        around = [(hb - ha, n) for n, ha, hb in host if ha <= mid <= hb]
        return min(around)[1] if around else "host (unmarked)"

    idle = sorted(gaps(ivals), key=lambda g: g[0] - g[1])[:top]
    return dict(
        busy_s=1e-6 * union_seconds(ivals), window_s=window_s,
        batches=batches, family_s=dict(fam_s),
        device_ops=[[n, s] for n, s in
                    sorted(op_s.items(), key=lambda t: -t[1])[:top]],
        idle_gaps=[[host_phase(a, b), 1e-6 * (b - a)] for a, b in idle])


def profiler_events(prof):
    """``summarize``'s event tuples from a finished ``torch.profiler``."""
    import torch

    out = []
    for e in prof.events():
        # a ``record_function`` range is mirrored on the device's timeline
        # as an annotation: it is no operation
        on = e.device_type == torch.autograd.DeviceType.CUDA and not (
            getattr(e, "is_user_annotation", False)
            or e.name.startswith(HOST_MARK))
        out.append((e.name, e.time_range.start, e.time_range.end, on))
    return out


def per_batch_ms(tr, families):
    """Device ms a batch of ``families``; None where none of them ran."""
    if tr is None:
        return None
    s = [tr["family_s"][f] for f in families if f in tr["family_s"]]
    if not s:
        return None
    return 1e3 * sum(s) / tr["batches"]
