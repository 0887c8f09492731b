"""The native (C++) planner search: ctypes binding with a build at first use.

Port of ``artensor_tpu/native/__init__.py``.  ``sa_kernel.cpp`` runs the
simulated-annealing search on flat arrays with all trials on C++ threads
(host code, not a device kernel).  It is built with g++ and the JAX
package's flags on first use into ``artensor_tpu_torch/_build/``
(git-ignored; or where ``ARTENSOR_TPU_CACHE`` points, ``cache.py``), named
by a hash of the source, the flags and the host CPU, so that the port's
build and the JAX package's are the same code on one host and give the
same plans, and a build is never loaded on another host.  The library is written through a temporary file and
``os.replace``, so processes building at once (pytest-xdist workers) never
load a half-written file.  When no toolchain is available the caller falls
back to the pure-Python search (``find_order(engine="auto")``) or raises
(``engine="native"``).
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time

import numpy as np

from ..planner import cost as _COST

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "sa_kernel.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
         "-pthread")
_LIB = None
_LIB_ERR = None
# seconds the last load spent compiling (0.0 when the cached library loaded)
BUILD_SECONDS = None


def _host_cpu():
    """The host CPU's model and feature flags (what ``-march=native``
    compiles for), so that a build directory copied to another host is
    not loaded there."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = f.read().split("\n\n")[0].splitlines()
    except OSError:
        import platform

        return platform.processor() or platform.machine()
    return "\n".join(ln for ln in lines
                     if ln.split(":")[0].strip() in ("model name", "flags"))


def _lib_path():
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(FLAGS).encode())
    h.update(_host_cpu().encode())
    return os.path.join(BUILD_DIR, f"sa_kernel_{h.hexdigest()[:16]}.so")


def _build():
    global BUILD_SECONDS
    path = _lib_path()
    if os.path.exists(path):
        BUILD_SECONDS = 0.0
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        subprocess.run(["g++", *FLAGS, _SRC, "-o", tmp], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    BUILD_SECONDS = time.perf_counter() - t0
    for fn in os.listdir(BUILD_DIR):     # stale builds of older sources
        if fn.startswith("sa_kernel_") and fn.endswith(".so") \
                and os.path.join(BUILD_DIR, fn) != path:
            try:
                os.remove(os.path.join(BUILD_DIR, fn))
            except OSError:
                pass
    return path


def load_kernel():
    """Load (building if needed) the native search; None if unavailable
    (the build's error is kept in ``build_error()``)."""
    global _LIB, _LIB_ERR
    if _LIB is not None or _LIB_ERR is not None:
        return _LIB
    from ..cache import enable_compile_cache

    enable_compile_cache()
    try:
        lib = ctypes.CDLL(_build())
    except Exception as e:  # noqa: BLE001 — no toolchain / platform
        _LIB_ERR = e
        return None
    fn = lib.sa_find_order
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_int,                        # n_tensors
        np.ctypeslib.ndpointer(np.int32),    # bond_offsets
        np.ctypeslib.ndpointer(np.int32),    # bond_ids
        ctypes.c_int,                        # n_bonds
        np.ctypeslib.ndpointer(np.float64),  # bond_log2dim
        np.ctypeslib.ndpointer(np.uint8),    # is_final
        ctypes.c_double,                     # log2_max_bitstring
        ctypes.c_int,                        # trials
        np.ctypeslib.ndpointer(np.int32),    # init_orders
        ctypes.c_int,                        # iters
        ctypes.c_int,                        # n_betas
        np.ctypeslib.ndpointer(np.float64),  # betas
        ctypes.c_double,                     # sc_target
        ctypes.c_double,                     # alpha
        ctypes.c_int,                        # slicing_repeat
        ctypes.c_uint64,                     # seed
        ctypes.c_int,                        # n_threads
        np.ctypeslib.ndpointer(np.int32),    # out_order
        np.ctypeslib.ndpointer(np.int32),    # out_sliced
        np.ctypeslib.ndpointer(np.float64),  # out_stats
        ctypes.c_int,                        # objective (0 score, 1 roofline)
        ctypes.c_double,                     # roofline muladds/s
        ctypes.c_double,                     # roofline bytes/s
        ctypes.c_double,                     # roofline step overhead, width 1
        ctypes.c_double,                     # roofline device budget bytes
        ctypes.c_double,                     # roofline full-rate K
        ctypes.c_double,                     # roofline step overhead floor
    ]
    _LIB = lib
    return _LIB


def native_available():
    return load_kernel() is not None


def build_error():
    """Why the native search did not build (None if it did or was not
    tried)."""
    return _LIB_ERR


def roofline_params(k_full=None):
    """The roofline objective's parameters on the H100 (``planner/cost``):
    the product rate, the memory rate, the width-1 step overhead, the
    device budget, the full-rate K and the per-step floor."""
    return dict(muladds_per_s=_COST.H100_COMPLEX_MULADD_PER_S,
                bytes_per_s=_COST.H100_HBM_BYTES_PER_S,
                step_overhead_w1_s=_COST.step_overhead_w1_s(),
                hbm_budget_bytes=_COST.HBM_BUDGET_BYTES,
                k_full=k_full or _COST.MMA_K_STEP,
                step_overhead_s=_COST.STEP_OVERHEAD_S)


def sa_find_order_native(tn, init_orders, sc_target, iters, betas,
                         slicing_repeat, seed, alpha=32.0, n_threads=None,
                         objective="score", k_full=None, roofline=None):
    """Run the native SA over an AbstractTensorNetwork.

    ``init_orders``: list (per trial) of pairwise orders over tensor ids.
    ``roofline``: the roofline objective's parameters
    (``roofline_params(k_full)`` by default).  Returns (order_pairs,
    sliced_bond_labels, (tc, sc, mc)).
    """
    lib = load_kernel()
    if lib is None:
        raise RuntimeError(f"native planner search unavailable: {_LIB_ERR}")
    tensor_ids = sorted(tn.tensor_bonds.keys())
    if tensor_ids != list(range(len(tensor_ids))):
        raise ValueError("the native planner needs dense tensor ids")
    rp = roofline or roofline_params(k_full)
    bonds = sorted(tn.bond_dims.keys(), key=str)
    bond_index = {b: k for k, b in enumerate(bonds)}
    offsets = [0]
    ids = []
    for t in tensor_ids:
        ids.extend(bond_index[b] for b in tn.tensor_bonds[t])
        offsets.append(len(ids))
    n = len(tensor_ids)
    trials = len(init_orders)
    flat_orders = np.asarray(
        [[x for pair in order for x in pair] for order in init_orders],
        dtype=np.int32)
    out_order = np.zeros((n - 1) * 2, dtype=np.int32)
    out_sliced = np.zeros(len(bonds), dtype=np.int32)
    out_stats = np.zeros(4, dtype=np.float64)
    betas = np.asarray(list(betas), dtype=np.float64)
    n_sliced = lib.sa_find_order(
        n,
        np.asarray(offsets, dtype=np.int32),
        np.asarray(ids, dtype=np.int32),
        len(bonds),
        np.asarray([np.log2(tn.bond_dims[b]) for b in bonds],
                   dtype=np.float64),
        np.asarray([1 if t in tn.final_qubits else 0 for t in tensor_ids],
                   dtype=np.uint8),
        float(tn.log2_max_bitstring),
        trials,
        np.ascontiguousarray(flat_orders),
        int(iters),
        len(betas),
        betas,
        float(sc_target),
        float(alpha),
        int(slicing_repeat),
        int(seed),
        int(n_threads if n_threads else (os.cpu_count() or 1)),
        out_order,
        out_sliced,
        out_stats,
        1 if objective == "roofline" else 0,
        float(rp["muladds_per_s"]),
        float(rp["bytes_per_s"]),
        float(rp["step_overhead_w1_s"]),
        float(rp["hbm_budget_bytes"]),
        float(rp["k_full"]),
        float(rp["step_overhead_s"]),
    )
    if n_sliced < 0:
        raise RuntimeError("native SA failed")
    order = [(int(out_order[2 * p]), int(out_order[2 * p + 1]))
             for p in range(n - 1)]
    sliced = [bonds[out_sliced[s]] for s in range(n_sliced)]
    return order, sliced, tuple(out_stats[:3])
