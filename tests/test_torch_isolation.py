"""The port stands alone: importing it (and chip_smoke.py and card_paths.py,
which the card tests and scripts share) loads neither JAX nor the JAX
package, and its entry points never fall back to the CPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

PROBE = """
import importlib, pkgutil, sys
import artensor_tpu_torch, card_paths, chip_smoke
for m in pkgutil.walk_packages(artensor_tpu_torch.__path__,
                               "artensor_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "artensor_tpu" or m.startswith("artensor_tpu."))
print("BAD", bad)
sys.exit(1 if bad else 0)
"""


def _clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_import_loads_no_jax():
    r = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=_clean_env())
    assert r.returncode == 0, r.stdout + r.stderr
    assert "BAD []" in r.stdout


@pytest.mark.parametrize("module", ["runtime.executor", "runtime.segmented",
                                    "runtime.rescaled", "runtime.checkpoint",
                                    "runtime.metrics", "simulation",
                                    "ops.einsum", "ops.field",
                                    "runtime.lowering", "planner.annealing",
                                    "native", "plan_io", "utils.mps",
                                    "utils.xeb", "circuits.cirq_compat",
                                    "runtime.scheme_cache", "cache",
                                    "__main__", "parallel",
                                    "parallel.distributed"])
def test_execution_modules_load_no_jax(module):
    """Each module of the execution modes and the front ends, imported
    alone in a fresh process, loads neither JAX nor the JAX package, and
    runs nothing (the CLI's ``__main__`` parses no argument: the probe's
    are ones it would refuse)."""
    probe = (f"import importlib, sys\n"
             f"importlib.import_module('artensor_tpu_torch.{module}')\n"
             "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'artensor_tpu'))\n"
             "print('BAD', bad)\n"
             "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", probe, "--no-such-flag"],
                       cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=_clean_env())
    assert r.returncode == 0, r.stdout + r.stderr
    assert "BAD []" in r.stdout


def test_port_sources_never_name_jax():
    pkg = os.path.join(ROOT, "artensor_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    for ln in fh:
                        s = ln.strip()
                        assert not (s.startswith("import jax")
                                    or s.startswith("from jax")
                                    or s.startswith("import artensor_tpu ")
                                    or s.startswith("from artensor_tpu ")
                                    or s.startswith("from artensor_tpu.")
                                    or s.startswith("import artensor_tpu.")
                                    ), (f, ln)


def test_entry_point_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from artensor_tpu_torch import TensorNetworkSimulation, random_circuit
    from artensor_tpu_torch.ops.field import SplitField
    from artensor_tpu_torch.runtime.executor import stage_tensors

    sim = TensorNetworkSimulation.from_circuit(
        random_circuit(3, 4, 8, seed=13), ["0" * 12, "1" * 12])
    with pytest.raises(RuntimeError, match="CUDA"):
        sim.prepare()          # default device: cuda
    with pytest.raises((RuntimeError, AssertionError)):
        stage_tensors(SplitField(), [np.ones(2, np.complex64)])


def test_chip_smoke_fails_without_cuda_or_repo(tmp_path):
    """Without a card, and alone in a directory, chip_smoke.py exits non-zero
    and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=_clean_env())
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env=_clean_env())
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


CARD_FILES = ("tests/test_torch_cuda.py", "tests/test_torch_card_paths.py")


def _card_run(tmp_path, marks, files=CARD_FILES, *extra):
    """Card test files under ``-m marks`` by the command the README gives
    (``--noconftest``: ``tests/conftest.py`` imports JAX), with a ``jax``
    that fails to import."""
    fake = tmp_path / "jax"
    fake.mkdir(exist_ok=True)
    (fake / "__init__.py").write_text(
        "raise ImportError('no JAX on this machine')\n")
    env = _clean_env()
    env["PYTHONPATH"] = str(tmp_path)
    cmd = [sys.executable, "-m", "pytest", "--noconftest", "-p",
           "no:cacheprovider", "-q", "-m", marks, *extra, *files]
    return subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=300, env=env)


def test_card_tests_run_without_jax(tmp_path):
    """The card tests run on a machine without JAX: each file is collected
    (pytest's exit code 1, a test failed, and not 2, a collection error),
    and here, in a run that asks for the card tests (``-m gpu``) without a
    card, its first card test fails for want of one rather than passing
    as skipped."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for f in CARD_FILES:
        r = _card_run(tmp_path, "gpu", (f,), "-x")
        out = r.stdout + r.stderr
        assert r.returncode == 1, (f, out[-3000:])
        assert "needs a CUDA card" in r.stdout, (f, out[-3000:])
        assert "ImportError" not in out, (f, out[-3000:])


def test_card_tests_skip_outside_a_card_run(tmp_path):
    """Run by a mark expression that does not ask for the card tests (the
    CPU suite's ``-m "not slow"``), without a card, they are skipped and
    nothing fails."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _card_run(tmp_path, "not slow")
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "error" not in r.stdout.lower()
    assert "failed" not in r.stdout.lower()
