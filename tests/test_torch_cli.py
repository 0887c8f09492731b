"""``python -m artensor_tpu_torch`` against ``python -m artensor_tpu`` on
the CPU (``--device cpu``): ``info``, ``plan``, ``simulate``, ``bench``
and ``verify`` on a small generated circuit written as a qsim file."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from artensor_tpu.__main__ import main as jax_main
from artensor_tpu.circuits.random_circuits import random_circuit
from artensor_tpu_torch.__main__ import main
from artensor_tpu_torch.circuits import TensorNetworkCircuit

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
BITS = ["000000", "111111", "010101", "101010"]
PLAN = ["--trials", "1", "--iters", "3", "--serial"]
BENCH_KEYS = {"wall_s", "compile_s", "slices", "steps", "sustained_tflops",
              "roofline_s", "roofline_achieved"}


def write_qsim(path, n, layers):
    """A qsim file of ``(n, layers)``, as tests/test_aux.py writes one."""
    lines = [str(n)]
    for li, layer in enumerate(layers):
        for name, qubits, params in layer:
            lines.append(" ".join(
                [str(li), name, *map(str, qubits), *map(str, params)]))
    path.write_text("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """random_circuit(2, 3, 4, seed=2) as a qsim file, its exact state, a
    sparse plan of ``BITS`` at sc_target 3 (8 slices) made by the JAX CLI
    and a dense one."""
    tmp = tmp_path_factory.mktemp("cli")
    n, layers = random_circuit(2, 3, 4, seed=2)
    qsim = tmp / "small.qsim"
    write_qsim(qsim, n, layers)
    sparse, dense = tmp / "sparse.json", tmp / "dense.json"
    jax_main(["plan", str(qsim), "--out", str(sparse), "--sc-target", "3",
              "--bitstrings", ",".join(BITS), *PLAN])
    jax_main(["plan", str(qsim), "--out", str(dense), *PLAN])
    psi = TensorNetworkCircuit((n, layers)).state_vec().reshape(-1)
    return dict(qsim=str(qsim), n=n, psi=psi, sparse=str(sparse),
                dense=str(dense), tmp=tmp)


def run(fn, argv, capsys):
    fn(argv)
    out = capsys.readouterr()
    return out.out, out.err


def amplitudes(text):
    got = {}
    for ln in text.strip().splitlines():
        bs, re, im = ln.split()
        got[bs] = complex(float(re), float(im))
    return got


@pytest.mark.parametrize("target", ["qsim", "sparse", "dense"])
def test_info_equals_jax(small, capsys, target):
    argv = ["info", small[target]]
    got = json.loads(run(main, argv, capsys)[0])
    assert got == json.loads(run(jax_main, argv, capsys)[0])
    if target == "qsim":
        assert got["qubits"] == small["n"]


@pytest.mark.parametrize("bits", [None, BITS], ids=["dense", "sparse"])
def test_plan_equals_jax_under_a_fixed_hash_seed(small, bits):
    """Both CLIs, each in a process of its own under PYTHONHASHSEED=0,
    save the same plan."""
    env = dict(os.environ, PYTHONHASHSEED="0", JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    plans = {}
    for pkg in ("artensor_tpu", "artensor_tpu_torch"):
        out = os.path.join(small["tmp"], f"plan_{pkg}_{bits is None}.json")
        argv = [sys.executable, "-m", pkg, "plan", small["qsim"], "--out",
                out, "--sc-target", "4", *PLAN]
        if bits:
            argv += ["--bitstrings", ",".join(bits)]
        r = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                           timeout=300, env=env)
        assert r.returncode == 0, r.stdout + r.stderr
        with open(out) as f:
            plans[pkg] = json.load(f)
        plans[pkg + " line"] = json.loads(r.stdout)
    jp, pp = plans["artensor_tpu"], plans["artensor_tpu_torch"]
    for key in ("order", "slicing_bonds", "tensor_bonds", "bond_dims",
                "final_qubits", "max_bitstring", "meta"):
        assert pp[key] == jp[key], key
    for key in ("tc", "sc", "mc"):
        assert pp["complexity"][key] == pytest.approx(
            jp["complexity"][key], abs=1e-12)
    jl, pl = plans["artensor_tpu line"], plans["artensor_tpu_torch line"]
    assert set(pl) == set(jl) and pl["sliced_bonds"] == jl["sliced_bonds"]


@pytest.mark.parametrize("use_plan", [False, True], ids=["planned", "plan"])
def test_simulate_sparse_equals_jax_and_state_vec(small, capsys, use_plan):
    argv = ["simulate", small["qsim"], "--bitstrings", ",".join(BITS), *PLAN]
    if use_plan:
        argv += ["--plan", small["sparse"]]
    out, err = run(main, argv + ["--device", "cpu"], capsys)
    got = amplitudes(out)
    assert sorted(got) == sorted(BITS)
    assert "steps x 8 slices" in err if use_plan else "slices" in err
    want = amplitudes(run(jax_main, argv, capsys)[0])
    for bs, amp in got.items():
        assert abs(amp - want[bs]) < 1e-6
        assert abs(amp - small["psi"][int(bs, 2)]) < 1e-6


def test_simulate_dense_and_out_equal_jax_and_state_vec(small, capsys):
    argv = ["simulate", small["qsim"], "--plan", small["dense"], "--head",
            "64"]
    got = amplitudes(run(main, argv + ["--device", "cpu"], capsys)[0])
    want = amplitudes(run(jax_main, argv, capsys)[0])
    assert len(got) == 2 ** small["n"] and sorted(got) == sorted(want)
    for bs, amp in got.items():
        assert abs(amp - want[bs]) < 1e-6
        assert abs(amp - small["psi"][int(bs, 2)]) < 1e-6
    npy = os.path.join(small["tmp"], "state.npy")
    out, err = run(main, ["simulate", small["qsim"], "--plan", small["dense"],
                          "--out", npy, "--device", "cpu"], capsys)
    assert out == "" and "-> " + npy in err
    state = np.load(npy)
    assert state.shape == (2 ** small["n"],)
    np.testing.assert_allclose(state, small["psi"], rtol=0, atol=1e-6)
    # complex128 and scientific notation through the same flags as JAX's
    out, err = run(main, argv + ["--device", "cpu", "--dtype", "complex128",
                                 "--scientific-notation", "--head", "4"],
                   capsys)
    factor = float(err.split("log10 factor:")[1].split()[0])
    for bs, amp in amplitudes(out).items():
        assert abs(amp * 10 ** factor - small["psi"][int(bs, 2)]) < 1e-10


def test_bench_prints_jax_keys(small, capsys):
    argv = ["bench", small["qsim"], "--plan", small["sparse"], "--bitstrings",
            ",".join(BITS), "--slice-batch", "2", "--repeats", "2"]
    got = json.loads(run(main, argv + ["--device", "cpu"], capsys)[0])
    want = json.loads(run(jax_main, argv, capsys)[0])
    assert set(got) == set(want) == BENCH_KEYS
    assert got["slices"] == want["slices"] == 8
    assert 0 < got["roofline_s"] and got["roofline_achieved"] == \
        pytest.approx(got["roofline_s"] / got["wall_s"])
    assert got["wall_s"] > 0 and got["compile_s"] > 0


def test_verify_exit_codes(small, capsys, monkeypatch):
    """0 against an exact oracle, 2 when the MPS is truncated (fidelity
    estimate at or below 0.999), 1 on a planted mismatch."""
    argv = ["verify", small["qsim"], "--serial", "--device", "cpu"]
    out, err = run(main, argv, capsys)
    stats = json.loads(err.strip().splitlines()[-1])
    assert stats["mps_fidelity_estimate"] > 0.999
    assert stats["max_abs_diff"] < stats["threshold"]
    assert len(out.strip().splitlines()) == 16
    with pytest.raises(SystemExit) as e:
        main(argv + ["--chi", "2"])
    assert e.value.code == 2
    assert "oracle too truncated" in capsys.readouterr().err

    from artensor_tpu_torch import simulation

    real = simulation.quantum_circuit_simulation

    def planted(*a, **k):
        amps, bits = real(*a, **k)
        amps = np.array(amps)
        amps[0] += 0.5 * 2.0 ** (-small["n"] / 2)
        return amps, bits

    monkeypatch.setattr(simulation, "quantum_circuit_simulation", planted)
    with pytest.raises(SystemExit) as e:
        main(argv + ["--bitstrings", ",".join(BITS)])
    assert e.value.code == 1


@pytest.mark.parametrize("command", ["simulate", "bench", "verify"])
def test_default_device_raises_without_a_card(small, command):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    argv = [command, small["qsim"], "--bitstrings", ",".join(BITS)]
    if command == "bench":
        argv += ["--plan", small["sparse"]]
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)


def test_cirq_file_through_the_cli(small, capsys, tmp_path):
    """A generated cirq file goes where a qsim file goes."""
    src = tmp_path / "circuit_n3.py"
    q = ["cirq.GridQubit(0, 0)", "cirq.GridQubit(0, 1)",
         "cirq.GridQubit(1, 0)"]
    src.write_text(
        "import cirq\n"
        f"QUBIT_ORDER = [{', '.join(q)}]\n"
        "CIRCUIT = cirq.Circuit([\n"
        f"    cirq.Moment([(cirq.X**0.5).on({q[0]}), cirq.H.on({q[1]}),\n"
        f"                 (cirq.Y**0.5).on({q[2]})]),\n"
        f"    cirq.Moment([cirq.FSimGate(theta=1.2, phi=0.4).on({q[0]}, "
        f"{q[1]})]),\n"
        f"    cirq.Moment([cirq.CZ.on({q[1]}, {q[2]})]),\n"
        f"    cirq.Moment([cirq.Rz(0.3).on({q[0]}), (cirq.X**0.5).on({q[1]}),"
        "\n"
        f"                 cirq.PhasedXPowGate(phase_exponent=0.25, "
        f"exponent=0.5).on({q[2]})]),\n"
        "])\n")
    info = json.loads(run(main, ["info", str(src)], capsys)[0])
    assert info == json.loads(run(jax_main, ["info", str(src)], capsys)[0])
    argv = ["simulate", str(src), "--head", "4", *PLAN]
    got = amplitudes(run(main, argv + ["--device", "cpu"], capsys)[0])
    want = amplitudes(run(jax_main, argv, capsys)[0])
    assert sorted(got) == [np.binary_repr(i, 3) for i in range(4)]
    for bs in got:
        assert abs(got[bs] - want[bs]) < 1e-6
