"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, bound with ``ctypes``: a file that
includes PyTorch's headers takes minutes to compile, a plain one seconds,
and the build runs at first use inside every fresh checkout.  The
compilers are started together, one per source.  ``pair.cu`` and
``gatherk.cu`` both include ``wgmma_core.cuh`` (the tensor-core product,
on wgmma, of Pair, the complex matmul and the GK and GGK mma form) and
``tc_core.cuh`` (its operands' split and the cp.async copies, which
``rgflat.cu`` also uses).  ``permute.cu`` is the copy kernel of every
reorder (``ops/permute.py``).  Libraries are cached
in ``_build/`` next to this file (git-ignored), or where
``ARTENSOR_TPU_CACHE`` points (``cache.py``), named by a hash of the
source, the headers and the flags, so an edited source or header rebuilds
and an unchanged one loads at once.

Nothing here runs at import: ``load()`` builds on its first call, from the
wrapper that first launches a kernel.  A failed build raises.  Every
kernel counts the launches that ran on the card (``csrc/runs.cuh``);
``device_runs()`` reads the step kernels' counts, ``read_runs`` any
source's (``ops.permute.permute_runs``: the copy kernel's, by mode).
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
DEFAULT_BUILD_DIR = Path(__file__).resolve().parent / "_build"
BUILD_DIR = DEFAULT_BUILD_DIR     # cache.enable_compile_cache may move it
SOURCES = ("gatherk", "rgrow", "rgflat", "lane", "pair", "permute")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# The H100 SXM's peak rates (data sheet): gatherk.gk_form picks a GK step's
# form from them, and chip_smoke.py states every kernel's bounds with them.
H100_HBM_BYTES_PER_S = 3.35e12
H100_FP32_FLOP_PER_S = 67e12    # float32 FMA, outside the tensor cores
H100_TF32_FLOP_PER_S = 495e12   # TF32 tensor cores, dense

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# argument types of every C entry point (pointers and the stream as void*,
# 64-bit sizes as long long: ctypes would otherwise pass 32-bit ints)
SIGNATURES = {
    "gatherk": {
        "gk_launch": [_P] * 9 + [_L, _I, _I, _I, _L, _L, _L, _L, _I, _I, _I,
                                  _I, _P],
        "ggk_launch": [_P] * 10 + [_L, _I, _I, _I, _L, _L, _L, _L, _I, _I,
                                    _I, _I, _P],
    },
    "rgrow": {
        "rgrow_launch": [_P] * 13 + [_L, _I, _I, _I, _I, _I, _I, _L, _L, _L,
                                     _L, _L, _I, _P],
    },
    "rgflat": {
        "rgflat_launch": [_P] * 9 + [_L] + [_I] * 9 + [_L, _L, _L, _I, _P],
    },
    "lane": {
        "lane_launch": [_P] * 11 + [_L, _I, _I, _I] + [_L] * 7 + [_I, _P],
    },
    "pair": {
        "pair_launch": [_P] * 6 + [_I, _I, _I, _L, _L, _L, _I, _I, _P],
        "cmm_launch": [_P] * 6 + [_I, _I, _I, _I, _L, _L, _I, _I, _I, _I,
                                  _P],
    },
    "permute": {
        "permute_launch": [_P] * 5 + [_I, _I, _I, _P],
        "permute_runs": [_P],
    },
}
# each step kernel's launches that ran on the card, counted by its kernels
# (csrc/runs.cuh), slot by slot: (kind, form); the pair kernel also runs
# the complex matmul.  The copy kernel (permute.cu) counts its own, read
# apart (ops.permute.permute_runs): device_runs() is the step kernels'
# census, which chip_smoke.py, the card tests and tnbench/progtrace.py
# hold to a scheme's steps and to a trace's step kernels
RUN_SLOTS = {
    "gatherk": (("gk", "stream"), ("gk", "mma"), ("ggk", "stream"),
                ("ggk", "mma")),
    "rgrow": (("rgrow", None),),
    "rgflat": (("rgflat", None),),
    "lane": (("lane", None),),
    "pair": (("pair", None), ("complex_mm", None)),
}
for _name in RUN_SLOTS:
    SIGNATURES[_name][f"{_name}_runs"] = [_P]


def wgmma_promote():
    """The k8 slices the wgmma core's 3xTF32 form sums inside the tensor
    cores before it adds them into float32 (``PROMOTE_3XTF32`` in
    ``csrc/wgmma_core.cuh``)."""
    m = re.search(r"constexpr int PROMOTE_3XTF32 = (\d+);",
                  (CSRC / "wgmma_core.cuh").read_text())
    return int(m.group(1))


class Kernels:
    """The loaded libraries: one attribute per C entry point, plus the
    build's wall seconds and the compilers' ``-Xptxas -v`` reports."""

    def __init__(self, libs, seconds, reports):
        self.seconds = seconds
        self.reports = reports
        self._libs = libs
        for name, fns in SIGNATURES.items():
            for fn, argtypes in fns.items():
                f = getattr(libs[name], fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
                setattr(self, fn, f)


_LOADED = None


def _nvcc():
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(name):
    # the headers (csrc/*.cuh) are part of every source's key
    src = b"".join(p.read_bytes() for p in
                   [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build():
    """Compile every source whose library is missing, all in parallel.
    Returns (seconds, {source: compiler report})."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return time.perf_counter() - t0, reports


def load():
    """Build (first call only) and load the kernels."""
    global _LOADED
    if _LOADED is None:
        from .cache import enable_compile_cache

        enable_compile_cache()
        seconds, reports = build()
        libs = {name: ctypes.CDLL(str(_target(name))) for name in SOURCES}
        _LOADED = Kernels(libs, seconds, reports)
    return _LOADED


def check(rc, name):
    """Raise on a launch the CUDA runtime refused (checked right after each
    launch; a fault during the run surfaces at the next synchronize)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def launch(name, fn, dev, *args):
    """Call the C entry point ``fn`` with ``args`` and, as its last
    argument, the current stream of CUDA device ``dev``, with ``dev`` the
    thread's current device for the call; raise if the launch was refused.

    Every kernel wrapper launches through here.  Each library links its own
    CUDA runtime, which launches on the context current to the thread;
    ``torch.cuda.device`` makes ``dev``'s context current (through
    PyTorch's runtime, and so for the CUDA driver both share), so an
    operand on ``cuda:1`` is launched on card 1 whichever card is current
    around the call.

    Returns the launches made, for the wrapper's count: 1, or 0 when the
    stream is being captured into a CUDA graph (the kernel is recorded,
    and runs at each replay, where no wrapper is called; the kernels' own
    counters count those, ``device_runs``)."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        check(fn(*args, ctypes.c_void_p(stream.cuda_stream)), name)
        return 0 if torch.cuda.is_current_stream_capturing() else 1


def read_runs(name, n):
    """The first ``n`` launch counters of source ``name`` (its C entry
    point ``<name>_runs``).  Waits for the card's work."""
    lib = load()
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * n)()
    check(getattr(lib, f"{name}_runs")(ctypes.cast(buf, ctypes.c_void_p)),
          f"{name}_runs")
    return list(buf)


def device_runs():
    """The launches of each step kernel that ran on the card so far, by
    ``(kind, form)`` (``RUN_SLOTS``), as the kernels count them
    (``csrc/runs.cuh``): a replay of a captured graph counts as a launch
    does, a capture counts nothing.  Waits for the card's work."""
    out = {}
    for name, slots in RUN_SLOTS.items():
        out.update(zip(slots, read_runs(name, len(slots))))
    return out


def tc_passes(precision):
    """The tensor-core passes of the kernels' tensor-core forms (Pair, GK
    and GGK "mma", the complex matmul) for a clamped kernel precision
    (``runtime/lanes.kernel_precision``): 1 (one TF32 pass) for
    'default', else 3 (3xTF32)."""
    return 1 if precision is not None and precision.passes == 1 else 3


def tf32_round(t):
    """``t`` (float32) with the low 13 mantissa bits of every element
    cleared: the operands the one-pass tensor-core form multiplies.  The
    plain versions' TF32 form rounds their operands so and multiplies
    them in float32."""
    return (t.contiguous().view(torch.int32) & -(1 << 13)).view(
        torch.float32)


def check_operands(name, tensors, shapes, contiguous=True):
    """Validate a wrapper's operands: one device (CPU or CUDA), float32,
    the expected shapes, contiguous (unless ``contiguous`` is False: the
    wrapper reads their strides).  Returns the device."""
    dev = tensors[0].device
    for t, shp in zip(tensors, shapes):
        if t.device != dev:
            raise ValueError(f"{name}: operands on different devices")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: operands must be float32, got {t.dtype}")
        if tuple(t.shape) != tuple(shp):
            raise ValueError(f"{name}: operand shape {tuple(t.shape)}, "
                             f"expected {tuple(shp)}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def slice_width(x_batched, w_batched, x, w):
    """The slice width of a call whose operands may carry a leading width
    axis (1 when neither does)."""
    if x_batched and w_batched and x.shape[0] != w.shape[0]:
        raise ValueError("slice widths of the two operands differ")
    if x_batched:
        return x.shape[0]
    return w.shape[0] if w_batched else 1


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())
