"""Where the port's build caches live, for every entry point.

Port of ``artensor_tpu/cache.py``.  The JAX package compiles its programs
at run time and keeps XLA's persistent compilation cache; the port
compiles nothing at run time, and its counterpart is the build cache of
its native code: the CUDA kernels' libraries (``kernels.BUILD_DIR``) and
the native planner search's (``native.BUILD_DIR``), each named by a hash
of its source and flags, so a warm directory loads at once.

``enable_compile_cache()`` is idempotent and called from the CLI and
before each build (``kernels.load``, ``native.load_kernel``).  Control:

  unset                      ``artensor_tpu_torch/_build/`` (git-ignored)
  ARTENSOR_TPU_CACHE=<dir>   both build caches in ``<dir>``
  ARTENSOR_TPU_CACHE=0       a temporary directory of this process,
                             removed at its exit (every process builds)

A build that fails raises, wherever it builds.
"""

import atexit
import os
import shutil
import tempfile

ENV = "ARTENSOR_TPU_CACHE"
_DIR = None


def enable_compile_cache(path=None):
    """Point both build caches at one directory (``path``, else as the
    environment says, see above) on the first call; later calls keep it.
    Returns the directory."""
    global _DIR
    if _DIR is not None:
        return _DIR
    from . import kernels, native

    env = os.environ.get(ENV)
    if env == "0":
        d = tempfile.mkdtemp(prefix="artensor_tpu_torch_build_")
        atexit.register(shutil.rmtree, d, True)
    else:
        d = path or env or str(kernels.DEFAULT_BUILD_DIR)
    d = os.path.abspath(d)
    kernels.BUILD_DIR = kernels.Path(d)
    native.BUILD_DIR = d
    _DIR = d
    return d
