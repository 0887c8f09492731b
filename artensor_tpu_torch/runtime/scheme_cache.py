"""Persistent scheme cache: the default sparse compile (gate-block fusion
and producer-order negotiation under the H100 wall estimate) costs 5-40 s
of host time per plan and batch, and its output is a pure function of the
plan, the bitstrings, sc_target, the compiler's code and the fitted
factors of the estimate; warm processes load the pickled steps instead.

Port of ``artensor_tpu/runtime/scheme_cache.py``.  The key hashes the plan
file, the sorted bitstrings, sc_target, the keyword arguments, the source
of every module the compile runs (``_SRC_MODULES``, with
``planner/cost.py`` and ``kernels.py``, whose constants the estimate
reads) and ``data/calibration_h100.json``: the default scheme depends on
the fitted factors, so a refit misses the cache, as an edit of the
compiler does.

The cache lives in ``artensor_tpu_torch/_scheme_cache/`` (git-ignored),
or in the directory ``ARTENSOR_TPU_TORCH_SCHEME_CACHE`` names.  Files are
written through a temporary file and ``os.replace`` (a cache that cannot
be written is logged and skipped); a file that does not load is rebuilt.
Only numpy arrays and plain objects are pickled: a torch tensor in the
steps (a kernel's device tables) raises.
"""

import hashlib
import logging
import os
import pickle

_RUNTIME = os.path.dirname(os.path.abspath(__file__))
_PACKAGE = os.path.dirname(_RUNTIME)
_SRC_MODULES = ("sparse", "scheme", "fuse", "negotiate", "lanes",
                "gatherk", "lowering", "metrics")
_SRC_FILES = tuple(os.path.join(_RUNTIME, m + ".py") for m in _SRC_MODULES) \
    + (os.path.join(_PACKAGE, "planner", "cost.py"),
       os.path.join(_PACKAGE, "kernels.py"))
ENV = "ARTENSOR_TPU_TORCH_SCHEME_CACHE"


def _compiler_hash():
    """The compiler's source and the estimate's fitted factors (read at
    every call: a refit in this process misses the cache too)."""
    from .metrics import CALIBRATION_PATH

    h = hashlib.sha256()
    for path in _SRC_FILES:
        with open(path, "rb") as f:
            h.update(f.read())
    if os.path.exists(CALIBRATION_PATH):
        with open(CALIBRATION_PATH, "rb") as f:
            h.update(f.read())
    else:
        h.update(b"no calibration")
    return h.hexdigest()[:16]


def cache_dir():
    d = os.environ.get(ENV) or os.path.join(_PACKAGE, "_scheme_cache")
    os.makedirs(d, exist_ok=True)
    return d


def _key(plan_path, bitstrings, sc_target, extra=()):
    h = hashlib.sha256()
    with open(plan_path, "rb") as f:
        h.update(f.read())
    h.update(repr(sorted(bitstrings)).encode())
    h.update(repr((float(sc_target), tuple(extra))).encode())
    h.update(_compiler_hash().encode())
    return h.hexdigest()[:32]


class _HostPickler(pickle.Pickler):
    """Refuses torch tensors: a cached scheme holds host data only."""

    def reducer_override(self, obj):
        import torch

        if isinstance(obj, torch.Tensor):
            raise TypeError("a scheme step holds a torch tensor "
                            f"({obj.device}); the cache keeps host data only")
        return NotImplemented


def cache_path(plan_path, bitstrings, sc_target, **kwargs):
    """The cache file ``cached_scheme_sparse`` reads and writes for these
    arguments."""
    key = _key(plan_path, bitstrings, sc_target,
               extra=sorted(kwargs.items()))
    return os.path.join(cache_dir(), f"sparse_{key}.pkl")


def cached_scheme_sparse(plan_path, ctree, bitstrings, sc_target,
                         **kwargs):
    """``contraction_scheme_sparse(ctree, bitstrings, sc_target, **kwargs)``
    through the cache keyed on the plan file ``plan_path`` (the plan
    ``ctree`` was loaded from), the bitstring set, sc_target, kwargs, the
    compiler's code and the calibration file."""
    from .sparse import contraction_scheme_sparse

    path = cache_path(plan_path, bitstrings, sc_target, **kwargs)
    if os.path.exists(path):
        try:
            with open(path, "rb") as f:
                return pickle.load(f)
        except Exception:  # noqa: BLE001 — any unreadable file: rebuild
            pass
    out = contraction_scheme_sparse(ctree, bitstrings,
                                    sc_target=sc_target, **kwargs)
    tmp = path + f".tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            _HostPickler(f, protocol=pickle.HIGHEST_PROTOCOL).dump(out)
        os.replace(tmp, path)
    except OSError as e:      # an unwritable cache: the compile stands
        logging.getLogger(__name__).warning("scheme cache not written: %s",
                                            e)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out
