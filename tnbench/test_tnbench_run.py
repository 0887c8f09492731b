"""Runs of the harness at a small size: on the CPU past the look for a
card, correct as it stands and not correct with the timed path broken
underneath; the refusals; and, on a card, the control."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from tnbench import manifest, run

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SEED = 2 ** 31 + 17
E2E = ["setup_s", "amps_per_s", "batch_p90_s"]


def small(mini, name):
    return manifest.cell(name, root=str(mini), here=str(mini / "tnbench"))


def drive(mini, name, trace=0, seconds=0.3):
    return run.execute(small(mini, name), SEED, seconds, trace, device="cpu")


@pytest.mark.parametrize("name", ["small-sparse", "small-dense",
                                  "small-share"])
def test_small_run_is_correct(mini, name):
    res = drive(mini, name)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert sorted(res["metrics"]) == sorted(E2E)
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert list(res)[-1] == "compared"
    for c in res["compared"].values():
        assert 0 <= c["value"] < c["limit"]
    json.dumps(res)


def test_trace_run_on_the_cpu_reads_no_device_metric(mini):
    res = drive(mini, "small-sparse", trace=1)
    assert res["correct"] is True
    assert sorted(res["metrics"]) == ["scheme_s"]
    assert "busy_s" not in res["device"] and "breakdown" not in res


@pytest.fixture
def broken(monkeypatch):
    """Breaks what the program's sliced runner returns, under ``prepare``
    and under a share's call alike: ``kind`` "amplitude" alters one answer
    where it is produced; "half_batch" leaves the second half of the
    batch's answers out (zero); "half" sums half of the slices and leaves
    the rest out."""
    from artensor_tpu_torch.runtime import executor

    def apply(kind):
        if kind == "half":
            inner = executor.slice_ids_tensor

            def half(slice_ids, n_slices, device):
                ids = inner(slice_ids, n_slices, device)
                return ids[:max(1, len(ids) // 2)]
            monkeypatch.setattr(executor, "slice_ids_tensor", half)
            return
        make = executor.make_sliced_runner

        def altered(*a, **k):
            run = make(*a, **k)

            def wrapped(tensors, slice_ids=None, init=None):
                out = run(tensors, slice_ids, init)
                re, im = (c.reshape(-1) for c in out)
                if kind == "half_batch":
                    re[re.numel() // 2:] = 0
                    im[im.numel() // 2:] = 0
                else:
                    re[re.numel() // 3] += 10 * float(re.abs().max())
                return out
            wrapped.stats, wrapped.capture = run.stats, run.capture
            return wrapped
        monkeypatch.setattr(executor, "make_sliced_runner", altered)
    return apply


@pytest.mark.parametrize("name,kind", [("small-sparse", "amplitude"),
                                       ("small-sparse", "half_batch"),
                                       ("small-sparse", "half"),
                                       ("small-dense", "amplitude"),
                                       ("small-dense", "half_batch"),
                                       ("small-share", "amplitude"),
                                       ("small-share", "half_batch"),
                                       ("small-share", "half")])
def test_broken_timed_path_is_not_correct(mini, broken, name, kind):
    broken(kind)
    res = drive(mini, name)
    assert res["correct"] is False
    assert res["failed"] >= 1
    assert any(c["value"] > c["limit"] for c in res["compared"].values())


@pytest.mark.parametrize("kind", [None, "half_batch", "half"])
def test_share_run_compared_at_a_sample(mini, broken, monkeypatch, kind):
    """The share cell with more bitstrings than the network reference
    computes: correct as it stands, and not correct with half of the
    batch's answers or half of its slices left out."""
    from tnbench import traffic

    monkeypatch.setattr(traffic, "REFERENCE_SAMPLES", 8)
    if kind:
        broken(kind)
    res = drive(mini, "small-share")
    assert res["correct"] is (kind is None)
    assert (res["failed"] == 0) is (kind is None)


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "artensor_tpu_torch_x", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "artensor_tpu.runtime", sys)
    assert run.forbidden_modules() == ["artensor_tpu", "jax"]


def test_run_refuses_without_a_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert run.main(["--workload", "sparse-1k", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 2
    out, err = capsys.readouterr()
    assert out == "" and "needs 1 CUDA" in err


def test_run_fails_without_the_program(tmp_path):
    """A checkout of BENCHMARK.json and the benchmark's folder alone."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "tnbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path[0] = sys.argv[1]\n"
            "from tnbench import manifest, run\n"
            "cell = manifest.cell('sparse-1k', root=sys.argv[1],"
            " here=sys.argv[1] + '/tnbench')\n"
            "print(run.execute(cell, 1, 0.1, 0, device='cpu'))\n")
    p = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0
    assert p.stdout == ""
    assert "artensor_tpu_torch" in p.stderr


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_of_the_benchmark_imports_jax():
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                for mod in _imports(os.path.join(dirpath, f)):
                    assert mod.split(".")[0] not in run.FORBIDDEN, (f, mod)


def test_reference_imports_nothing_of_the_program(mini):
    """Both references, by their sources and by a run of each in a fresh
    process (the network one along the small share cell's plan)."""
    ref = os.path.join(HERE, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            for mod in _imports(os.path.join(ref, f)):
                assert mod.split(".")[0] in ("json", "math", "numpy",
                                             "torch"), mod
    code = ("import sys; sys.path[0] = sys.argv[1]\n"
            "import tnbench.reference.statevector as s\n"
            "import tnbench.reference.network as net\n"
            "from tnbench.circuits import random_circuit\n"
            "s.state_vector(4, [[('x_1_2', (0,), ())]])\n"
            "n, layers = random_circuit(3, 4, 8, sites=eval(sys.argv[3]))\n"
            "net.amplitudes(n, layers, sys.argv[2], ['0' * n], range(2))\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    plan = str(mini / "tnbench" / "configs" / "small-share-plan.json")
    sites = repr(small(mini, "small-share").config["circuit"]["sites"])
    p = subprocess.run([sys.executable, "-c", code, ROOT, plan, sites],
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    loaded = set(ast.literal_eval(p.stdout.strip()))
    assert not loaded & {"artensor_tpu_torch", *run.FORBIDDEN}


def test_a_run_loads_no_jax(mini):
    """A whole small run in a fresh process, its modules checked after."""
    code = ("import sys; sys.path[0] = sys.argv[1]\n"
            "from tnbench import manifest, run\n"
            "cell = manifest.cell('small-sparse', root=sys.argv[2],"
            " here=sys.argv[2] + '/tnbench')\n"
            "res = run.execute(cell, 5, 0.2, 0, device='cpu')\n"
            "print(res['correct'], run.forbidden_modules(),"
            " 'artensor_tpu_torch' in sys.modules)\n")
    p = subprocess.run([sys.executable, "-c", code, ROOT, str(mini)],
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == "True [] True"


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["small-sparse", "small-dense"])
def test_control_is_not_correct_on_the_card(mini, card, name):
    """The program as the configuration states it passes; its one-pass
    TF32 path (precision "default"), the control, fails."""
    from tnbench.session import Run

    cell = small(mini, name)
    got = {}
    for precision in ("highest", "default"):
        r = Run(cell, SEED, "cuda", precision=precision)
        r.setup()
        r.window(0.5)
        r.release()
        got[precision] = r.check(cell.limits)[0]
    assert got == {"highest": True, "default": False}


def test_control_readings_on_the_cpu(mini, capsys):
    """``control.py`` reads both precisions of each seed against one
    reference (on the CPU every precision computes in float32)."""
    from tnbench import control

    cell = small(mini, "small-sparse")
    assert control.main(["--workload", "small-sparse", "--seeds", "3,4",
                         "--seconds", "0.2", "--device", "cpu"],
                        cell=cell) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert [(r["seed"], r["precision"]) for r in lines] == [
        (3, "highest"), (3, "default"), (4, "highest"), (4, "default")]
    assert all(r["failed"] == 0 and r["err_l2"] < 1e-5 for r in lines)
