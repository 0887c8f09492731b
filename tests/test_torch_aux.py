"""The port's auxiliary front ends against the JAX package's: the XEB
estimators, the truncated-MPS oracle, the einsum and MPS exports, the cirq
loader (and its AST allowlist), the scheme roofline, the scheme cache and
the build cache.  Every input comes from a numpy seed."""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from artensor_tpu.circuits import TensorNetworkCircuit as JaxCircuit
from artensor_tpu.circuits import cirq_compat as jcirq
from artensor_tpu.circuits.random_circuits import random_circuit
from artensor_tpu.utils import mps as jmps
from artensor_tpu.utils import xeb as jxeb
from artensor_tpu_torch import TensorNetworkSimulation
from artensor_tpu_torch import random_circuit as prandom_circuit
from artensor_tpu_torch.circuits import TensorNetworkCircuit
from artensor_tpu_torch.circuits import cirq_compat as pcirq
from artensor_tpu_torch.plan_io import plan_from_dict
from artensor_tpu_torch.runtime import executor as pex
from artensor_tpu_torch.runtime import metrics as pmt
from artensor_tpu_torch.runtime import scheme_cache as scc
from artensor_tpu_torch.runtime.sparse import (contraction_scheme_sparse,
                                               scheme_digest)
from artensor_tpu_torch.utils import mps as pmps
from artensor_tpu_torch.utils import xeb as pxeb

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
DATA = os.path.join(ROOT, "artensor_tpu_torch", "data")
SPARSE_PLANS = {   # the committed n30 plans: (plan, fixture of its batch)
    "1k": ("rcs_n30_m14_s0_sparse_sc24.json", "rcs_n30_m14_s0_amps1000.txt"),
    "10k": ("rcs_n30_m14_s0_sparse10k_sc24.json",
            "rcs_n30_m14_s0_amps10000.txt"),
    "1k-sc25": ("rcs_n30_m14_s0_sparse_sc25.json",
                "rcs_n30_m14_s0_amps1000.txt"),
}
RGF_PLAN = os.path.join(ROOT, "tests", "data",
                        "torch_port_rcs15_rgflat_plan.json")

SMALL = """4
0 h 0
0 h 1
0 x_1_2 2
0 y_1_2 3
1 fsim 0 1 1.5 0.5
1 fsim 2 3 1.4 0.6
2 rz 0 0.3
2 hz_1_2 1
2 t 2 0.25
3 cz 1 2
"""
# non-adjacent two-qubit gates both ways round (SWAP routing)
LONG_RANGE = (5, [
    [("h", (0,), ()), ("h", (3,), ()), ("x_1_2", (4,), ())],
    [("cz", (0, 3), ())],
    [("fsim", (4, 1), (0.3, 0.2)), ("y_1_2", (2,), ())],
    [("cnot", (2, 0), ())],
    [("fsim", (0, 4), (1.1, 0.4)), ("hz_1_2", (3,), ())],
])


# -- XEB ----------------------------------------------------------------------

def test_xeb_equals_jax():
    rng = np.random.default_rng(11)
    n = 10
    amps = (rng.normal(size=500) + 1j * rng.normal(size=500)) / 2 ** (n / 2)
    ref = amps * (1 + 0.03 * rng.normal(size=500))
    other = rng.normal(size=500) + 1j * rng.normal(size=500)
    for sampled in (True, False):
        assert pxeb.linear_xeb(amps, n, sampled) == \
            jxeb.linear_xeb(amps, n, sampled)
    assert pxeb.xeb_against_ground_truth(amps, ref) == \
        jxeb.xeb_against_ground_truth(amps, ref)
    assert pxeb.xeb_against_ground_truth(amps, ref, rel_tol=0.01) == \
        jxeb.xeb_against_ground_truth(amps, ref, rel_tol=0.01)
    assert pxeb.state_fidelity(amps, other) == \
        jxeb.state_fidelity(amps, other)
    assert pxeb.state_fidelity(amps, 0 * other) == 0.0
    for k in (0, 3, 7):
        assert pxeb.sliced_fidelity_estimate(k) == \
            jxeb.sliced_fidelity_estimate(k)


# -- the MPS oracle -----------------------------------------------------------

MPS_CIRCUITS = {"rcs6": lambda: random_circuit(2, 3, 6, seed=4),
                "long-range": lambda: LONG_RANGE}


@pytest.mark.parametrize("chi", [64, 4])
@pytest.mark.parametrize("canonical", [True, False])
@pytest.mark.parametrize("name", sorted(MPS_CIRCUITS))
def test_mps_equals_jax(name, canonical, chi):
    """Amplitudes and fidelity estimate within 1e-12 of JAX's at an exact
    bond cap and a truncating one; at the exact cap the port's state is
    the exact state."""
    n, layers = MPS_CIRCUITS[name]()
    got = pmps.mps_simulate(TensorNetworkCircuit((n, layers)), chi=chi,
                            canonical=canonical)
    want = jmps.mps_simulate(JaxCircuit((n, layers)), chi=chi,
                             canonical=canonical)
    rng = np.random.default_rng(2)
    for b in rng.choice(2 ** n, 12, replace=False):
        bits = np.binary_repr(b, n)
        assert abs(got.amplitude(bits) - want.amplitude(bits)) < 1e-12
    assert abs(got.fidelity_estimate - want.fidelity_estimate) < 1e-12
    assert got.max_bond() == want.max_bond()
    np.testing.assert_allclose(got.state_vec(), want.state_vec(),
                               rtol=0, atol=1e-12)
    if chi == 64:
        exact = TensorNetworkCircuit((n, layers)).state_vec().reshape(-1)
        np.testing.assert_allclose(got.state_vec(), exact, rtol=0,
                                   atol=1e-10)
        assert got.fidelity_estimate == 1.0
    elif name == "rcs6":
        assert got.fidelity_estimate < 1.0


def test_mps_reads_a_qsim_path_and_init_state(tmp_path):
    path = tmp_path / "small.qsim"
    path.write_text(SMALL)
    got = pmps.mps_simulate(str(path), chi=16)
    np.testing.assert_allclose(
        got.state_vec(), TensorNetworkCircuit(SMALL).state_vec().reshape(-1),
        rtol=0, atol=1e-12)
    c = TensorNetworkCircuit(SMALL, init_state="0110")
    np.testing.assert_allclose(pmps.mps_simulate(c).state_vec(),
                               c.state_vec().reshape(-1), rtol=0, atol=1e-12)


# -- einsum and MPS exports ---------------------------------------------------

EXPORTS = {"small": lambda: dict(source=SMALL),
           "projected": lambda: dict(source=SMALL, init_state="0101",
                                     final_state="1100"),
           "rcs-1x6": lambda: dict(source=random_circuit(1, 6, 4, seed=3))}


@pytest.mark.parametrize("name", sorted(EXPORTS))
def test_to_einsum_and_to_mps_equal_jax(name):
    got = TensorNetworkCircuit(**EXPORTS[name]())
    want = JaxCircuit(**EXPORTS[name]())
    ga, gops, gout = got.to_einsum()
    wa, wops, wout = want.to_einsum()
    assert gops == wops and gout == wout
    assert all(np.array_equal(a, b) for a, b in zip(ga, wa))
    gs, geq = got.to_einsum(as_string=True)
    _, weq = want.to_einsum(as_string=True)
    assert geq == weq
    full = np.einsum(geq, *gs, optimize="greedy")
    np.testing.assert_allclose(full, got.state_vec(), rtol=0, atol=1e-12)
    if got.final_state is None:
        gm, wm = got.to_mps(), want.to_mps()
        assert len(gm) == len(wm)
        for a, b in zip(gm, wm):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


def test_to_mps_and_letter_einsum_refusals():
    with pytest.raises(ValueError, match="nearest-neighbour"):
        TensorNetworkCircuit(LONG_RANGE).to_mps()
    deep = random_circuit(1, 6, 8, seed=3)       # 80 bond labels
    with pytest.raises(ValueError, match="52-letter"):
        TensorNetworkCircuit(deep).to_einsum(as_string=True)
    with pytest.raises(ValueError, match="52-letter"):
        JaxCircuit(deep).to_einsum(as_string=True)


# -- the cirq loader ----------------------------------------------------------

GENERIC = """import cirq
QUBIT_ORDER = [cirq.GridQubit(0, 0), cirq.GridQubit(0, 1),
               cirq.GridQubit(1, 0)]
CIRCUIT = cirq.Circuit([
    cirq.Moment([(cirq.X**0.25).on(cirq.GridQubit(0, 0)),
                 cirq.H.on(cirq.GridQubit(0, 1)),
                 (cirq.Y**0.5).on(cirq.GridQubit(1, 0))]),
    cirq.Moment([(cirq.CZ**0.3).on(cirq.GridQubit(0, 0),
                                   cirq.GridQubit(0, 1)),
                 cirq.Rx(0.7).on(cirq.GridQubit(1, 0))]),
    cirq.Moment([(cirq.ISWAP**0.5).on(cirq.GridQubit(0, 1),
                                      cirq.GridQubit(1, 0)),
                 cirq.T.on(cirq.GridQubit(0, 0))]),
    cirq.Moment([cirq.PhasedXPowGate(phase_exponent=0.1,
                                     exponent=0.7).on(
                     cirq.GridQubit(0, 0)),
                 cirq.Ry(0.3).on(cirq.GridQubit(0, 1)),
                 (cirq.Z**0.6).on(cirq.GridQubit(1, 0))]),
])
"""
SYCAMORE = """import cirq
import numpy as np

QUBIT_ORDER = [
    cirq.GridQubit(0, 5), cirq.GridQubit(0, 6), cirq.GridQubit(1, 5),
    cirq.GridQubit(1, 6),
]

CIRCUIT = cirq.Circuit(
    [
        cirq.Moment(
            operations=[
                (cirq.X**0.5).on(cirq.GridQubit(0, 5)),
                (cirq.Y**0.5).on(cirq.GridQubit(0, 6)),
                cirq.PhasedXPowGate(phase_exponent=0.25, exponent=0.5).on(
                    cirq.GridQubit(1, 5)),
                (cirq.X**0.5).on(cirq.GridQubit(1, 6)),
            ]
        ),
        cirq.Moment(
            operations=[
                cirq.Rz(np.pi * -0.3).on(cirq.GridQubit(0, 5)),
                cirq.Rz(np.pi * 0.7).on(cirq.GridQubit(1, 5)),
            ]
        ),
        cirq.Moment(
            operations=[
                cirq.FSimGate(theta=1.5707963267948966,
                              phi=0.5235987755982988).on(
                    cirq.GridQubit(0, 5), cirq.GridQubit(0, 6)),
                cirq.FSimGate(theta=1.4, phi=-0.5).on(
                    cirq.GridQubit(1, 5), cirq.GridQubit(1, 6)),
            ]
        ),
        cirq.Moment(
            operations=[
                (cirq.Y**0.5).on(cirq.GridQubit(0, 5)),
                cirq.PhasedXPowGate(phase_exponent=0.25, exponent=0.5).on(
                    cirq.GridQubit(0, 6)),
                cirq.FSimGate(theta=1.5, phi=0.2).on(
                    cirq.GridQubit(0, 5), cirq.GridQubit(1, 5)),
            ]
        ),
    ]
)
"""


def _same_layers(got, want):
    (gn, gl), (wn, wl) = got, want
    assert gn == wn and len(gl) == len(wl)
    for la, lb in zip(gl, wl):
        assert len(la) == len(lb)
        for (na, qa, pa), (nb, qb, pb) in zip(la, lb):
            assert na == nb and qa == qb and len(pa) == len(pb)
            for a, b in zip(pa, pb):
                assert np.abs(np.asarray(a) - np.asarray(b)).max() < 1e-12


@pytest.mark.parametrize("src", [GENERIC, SYCAMORE],
                         ids=["generic", "sycamore"])
def test_cirq_loader_equals_jax(tmp_path, src):
    path = tmp_path / "circuit.py"
    path.write_text(src)
    got = pcirq.load_cirq_circuit(str(path))
    _same_layers(got, jcirq.load_cirq_circuit(str(path)))
    assert "cirq" not in sys.modules
    if src is SYCAMORE:
        names = {g[0] for layer in got[1] for g in layer}
        assert names == {"x_1_2", "y_1_2", "hz_1_2", "rz", "fsim"}
    psi = TensorNetworkCircuit(got).state_vec().reshape(-1)
    np.testing.assert_allclose(
        psi, JaxCircuit(got).state_vec().reshape(-1), rtol=0, atol=1e-12)


# files the allowlist rejects: each would do something if it ran (the
# first statement builds a circuit, which the shim's collector records)
REJECTED = {
    "import": "import cirq\nC = cirq.Circuit([])\nimport os\n",
    "def": "import cirq\nC = cirq.Circuit([])\ndef f():\n    return 1\n",
    "dunder": "import cirq\nC = cirq.Circuit([])\n"
              "K = cirq.GridQubit.__init__\n",
    "chained": "import cirq\nimport numpy as np\nC = cirq.Circuit([])\n"
               "P = np.ctypeslib.as_array\n",
}


@pytest.mark.parametrize("name", sorted(REJECTED))
@pytest.mark.parametrize("mod", [pcirq, jcirq], ids=["port", "jax"])
def test_cirq_loader_rejects_and_runs_nothing(tmp_path, monkeypatch, mod,
                                              name):
    path = tmp_path / f"evil_{name}.py"
    path.write_text(REJECTED[name])
    built = []
    real = mod._shim_namespace
    monkeypatch.setattr(mod, "_shim_namespace", lambda collector: real(
        lambda moments: built.append(moments)))
    with pytest.raises(ValueError, match="disallowed"):
        mod.load_cirq_circuit(str(path))
    assert built == []
    assert "cirq" not in sys.modules


def test_pow_u_equals_jax():
    rng = np.random.default_rng(7)
    A = rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4))
    Q, _ = np.linalg.qr(A)
    U = Q @ np.diag([1j, 1j, np.exp(0.3j), np.exp(-0.9j)]) @ np.conj(Q.T)
    for t in (0.5, 0.3, -1.2):
        np.testing.assert_allclose(pcirq._pow_u(U, t), jcirq._pow_u(U, t),
                                   rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="non-unitary"):
        pcirq._pow_u(np.diag([2.0, 1.0]), 0.5)


class _FakeQubit:
    def __init__(self, r, c):
        self.key = (r, c)

    def __hash__(self):
        return hash(self.key)

    def __eq__(self, o):
        return self.key == o.key

    def __lt__(self, o):
        return self.key < o.key


class _FakeGate:
    def __init__(self, U):
        self._U = np.asarray(U, complex)

    def _unitary_(self):
        return self._U

    def on(self, *qubits):
        return _FakeOp(self, qubits)


class _FakeOp:
    def __init__(self, gate, qubits):
        self.gate = gate
        self.qubits = tuple(qubits)


class _FakeCircuit:
    def __init__(self, moments):
        self._moments = moments

    def __iter__(self):
        return iter(self._moments)

    def all_qubits(self):
        return {q for m in self._moments for op in m for q in op.qubits}


def test_from_cirq_equals_jax():
    from artensor_tpu.circuits import from_cirq as jfrom
    from artensor_tpu_torch import from_cirq

    rng = np.random.default_rng(3)

    def rand_u(n):
        Q, _ = np.linalg.qr(rng.normal(size=(n, n))
                            + 1j * rng.normal(size=(n, n)))
        return Q

    q = [_FakeQubit(0, 0), _FakeQubit(0, 1), _FakeQubit(1, 0)]
    H = np.array([[1, 1], [1, -1]], complex) / np.sqrt(2)
    U1, U2 = rand_u(2), rand_u(4)
    circ = _FakeCircuit([
        [_FakeGate(H).on(q[0]), _FakeGate(U1).on(q[2])],
        [_FakeGate(U2).on(q[0], q[1])],
        [],
        [_FakeGate(U2).on(q[1], q[2])],
    ])
    got = from_cirq(circ)
    _same_layers(got, jfrom(circ))
    assert got[0] == 3 and len(got[1]) == 3
    np.testing.assert_allclose(
        TensorNetworkCircuit(got).state_vec(), JaxCircuit(got).state_vec(),
        rtol=0, atol=1e-12)
    order = [q[2], q[1], q[0]]
    _same_layers(from_cirq(circ, order), jfrom(circ, order))

    class _NoU:
        gate = None
        qubits = (_FakeQubit(0, 0),)

    with pytest.raises(ValueError, match="no unitary"):
        from_cirq(_FakeCircuit([[_NoU()]]))


# -- the scheme roofline ------------------------------------------------------

def _n30_sim(name):
    plan, fixture = SPARSE_PLANS[name]
    with open(os.path.join(DATA, fixture)) as f:
        bits = [ln.split()[0] for ln in f if ln.strip()]
    with open(os.path.join(DATA, plan)) as f:
        pd = json.load(f)
    sim = TensorNetworkSimulation.from_circuit(
        prandom_circuit(5, 6, 14, seed=0), bits)
    sim.order, sim.slicing_bonds, sim.ctree = plan_from_dict(pd)
    return sim, pd["meta"]["sc_target"]


def _step_floor(s):
    """One step's floor, from the card's data-sheet rates."""
    tf32_3x, hbm, k_step = 495e12 / 3, 3.35e12, 8

    def compute(low):
        (cx, _), _ = low.dnums
        k = int(np.prod([low.shape_l[d] for d in cx]))
        return pmt.step_flops(low) / (tf32_3x * min(1.0, k / k_step))

    lows = [s.lowered] if s.lowered is not None else list(s.lowered_chunks)
    if s.lane is not None:
        nbytes = min(sum(pmt.step_traffic_bytes(low) for low in lows),
                     pmt.plan_bytes(s.lane)[1])
        floor = max(sum(compute(low) for low in lows), nbytes / hbm)
        assert floor <= sum(pmt.plan_design_bound(s.lane)[1:]) * (1 + 1e-12)
        return floor
    return sum(max(compute(low), pmt.step_traffic_bytes(low) / hbm)
               for low in lows)


@pytest.mark.parametrize("name", sorted(SPARSE_PLANS))
def test_roofline_is_the_sum_of_step_floors_below_the_estimate(name):
    """On each committed sparse plan (its scheme in the off form, and the
    default form of 1k-sc25): the roofline is the sum of the steps'
    floors, each kernel step's at most its design bound, and below the
    calibrated wall estimate."""
    sim, sc = _n30_sim(name)
    forms = [dict(fuse=False, negotiate=False)]
    if name == "1k-sc25":
        forms.append({})
    for kw in forms:
        sim._set_scheme(*contraction_scheme_sparse(sim.ctree, sim.bitstrings,
                                                   sc, **kw))
        run, _ = pex.precompute_static_steps(
            sim.steps, [sim.tensors[i] for i in range(len(sim.tensors))],
            sim.slicing_axes)
        assert any(s.lane is not None for s in run)
        roof = pmt.scheme_roofline_seconds(run)
        assert roof == pytest.approx(sum(_step_floor(s) for s in run),
                                     rel=1e-12)
        k = len(sim.slicing_bonds)
        est, _, _ = pmt.scheme_wall_estimate(run, k,
                                             slicing_axes=sim.slicing_axes)
        assert 0 < 2 ** k * roof <= est
        # a GK step's lowered product names the gathered view; the floor
        # counts what the kernel reads
        assert any(s.lane is not None and pmt.plan_bytes(s.lane)[1]
                   < sum(pmt.step_traffic_bytes(low) for low in
                         ([s.lowered] if s.lowered is not None
                          else s.lowered_chunks)) for s in run)
        # the rates can be given, as in the JAX signature
        assert pmt.scheme_roofline_seconds(
            run, muladds_per_s=495e12 / 6, bytes_per_s=3.35e12 / 2) \
            >= roof


# -- the scheme cache ---------------------------------------------------------

@pytest.fixture
def rcs15(tmp_path, monkeypatch):
    """The committed small plan with an RGFlat step and its 128 bitstrings,
    the scheme cache in a fresh directory."""
    monkeypatch.setenv(scc.ENV, str(tmp_path / "schemes"))
    n, layers = prandom_circuit(3, 5, 8, seed=13)
    rng = np.random.default_rng(4)
    bits = [np.binary_repr(b, n)
            for b in rng.choice(2 ** n, 128, replace=False)]
    with open(RGF_PLAN) as f:
        pd = json.load(f)
    _, _, ctree = plan_from_dict(pd)
    return RGF_PLAN, ctree, bits, pd["meta"]["sc_target"], tmp_path


def _same_scheme(a, b):
    (sa, oa, ba), (sb, ob, bb) = a, b
    assert oa == ob and list(ba) == list(bb) and len(sa) == len(sb)
    assert scheme_digest(sa) == scheme_digest(sb)
    for x, y in zip(sa, sb):
        assert pickle.dumps(x) == pickle.dumps(y)


def test_scheme_cache_round_trip_equals_a_fresh_compile(rcs15):
    plan, ctree, bits, sc, tmp = rcs15
    fresh = contraction_scheme_sparse(ctree, bits, sc_target=sc)
    cold = scc.cached_scheme_sparse(plan, ctree, bits, sc)
    files = os.listdir(tmp / "schemes")
    assert len(files) == 1
    warm = scc.cached_scheme_sparse(plan, ctree, bits, sc)
    assert os.listdir(tmp / "schemes") == files
    _same_scheme(fresh, cold)
    _same_scheme(fresh, warm)
    # what is pickled is host data: the file names no class of torch
    modules = set()

    class Recorder(pickle.Unpickler):
        def find_class(self, module, name):
            modules.add(module)
            return super().find_class(module, name)

    with open(tmp / "schemes" / files[0], "rb") as f:
        Recorder(f).load()
    assert modules and not any(m.split(".")[0] == "torch" for m in modules)
    # a corrupt file is rebuilt, and rewritten
    with open(tmp / "schemes" / files[0], "wb") as f:
        f.write(b"\x80\x05not a pickle")
    _same_scheme(fresh, scc.cached_scheme_sparse(plan, ctree, bits, sc))
    with open(tmp / "schemes" / files[0], "rb") as f:
        _same_scheme(fresh, pickle.load(f))


def test_scheme_cache_key_follows_every_input(rcs15, monkeypatch):
    plan, ctree, bits, sc, tmp = rcs15
    base = scc.cache_path(plan, bits, sc)
    assert scc.cache_path(plan, list(reversed(bits)), sc) == base
    assert scc.cache_path(plan, bits[:100], sc) != base
    assert scc.cache_path(plan, bits, sc + 1) != base
    assert scc.cache_path(plan, bits, sc, fuse=False) != base
    other = tmp / "plan.json"
    with open(plan) as f:
        pd = json.load(f)
    pd["meta"]["note"] = "another file"
    other.write_text(json.dumps(pd))
    assert scc.cache_path(str(other), bits, sc) != base
    # a refit of the estimate's factors misses the cache
    cal = tmp / "calibration_h100.json"
    with open(pmt.CALIBRATION_PATH) as f:
        fitted = json.load(f)
    cal.write_text(json.dumps(fitted))
    monkeypatch.setattr(pmt, "CALIBRATION_PATH", str(cal))
    assert scc.cache_path(plan, bits, sc) != base   # bytes differ
    same = scc.cache_path(plan, bits, sc)
    fitted["family_factors"]["gk"] *= 1.5
    cal.write_text(json.dumps(fitted))
    assert scc.cache_path(plan, bits, sc) not in (base, same)
    monkeypatch.setattr(pmt, "CALIBRATION_PATH", str(tmp / "absent.json"))
    assert scc.cache_path(plan, bits, sc) not in (base, same)


def test_scheme_cache_refuses_device_tensors(rcs15):
    plan, ctree, bits, sc, tmp = rcs15
    out = contraction_scheme_sparse(ctree, bits, sc_target=sc)
    with open(tmp / "x.pkl", "wb") as f:
        with pytest.raises(TypeError, match="torch tensor"):
            scc._HostPickler(f).dump((out, torch.zeros(2)))


# -- the build cache ----------------------------------------------------------

PROBE = """
import os, sys
from artensor_tpu_torch import cache, kernels, native
d = cache.enable_compile_cache()
assert cache.enable_compile_cache() == d
assert str(kernels.BUILD_DIR) == d == native.BUILD_DIR, (d, kernels.BUILD_DIR)
lib = native._build()
assert os.path.dirname(lib) == d and os.path.exists(lib)
try:
    kernels.load()
except RuntimeError as e:
    print("RAISED", str(e).splitlines()[0])
print("DIR", d)
"""


def _probe(env_value, tmp_path):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.pop("ARTENSOR_TPU_CACHE", None)
    if env_value is not None:
        env["ARTENSOR_TPU_CACHE"] = env_value
    env["TMPDIR"] = str(tmp_path)
    r = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    out = dict(ln.split(" ", 1) for ln in r.stdout.splitlines())
    return out


def test_build_cache_directory_follows_the_environment(tmp_path):
    """``ARTENSOR_TPU_CACHE=<dir>`` moves both build caches there (the
    native search builds into it); ``=0`` gives each process a fresh
    temporary directory, removed at its exit; unset, ``_build/``.  A
    kernel build that cannot run (no nvcc here) still raises."""
    moved = _probe(str(tmp_path / "builds"), tmp_path)
    assert moved["DIR"] == str(tmp_path / "builds")
    assert any(f.startswith("sa_kernel_")
               for f in os.listdir(tmp_path / "builds"))
    a = _probe("0", tmp_path)["DIR"]
    b = _probe("0", tmp_path)["DIR"]
    assert a != b and os.path.dirname(a) == str(tmp_path)
    assert not os.path.exists(a) and not os.path.exists(b)
    default = _probe(None, tmp_path)
    assert default["DIR"] == os.path.join(
        os.path.realpath(ROOT), "artensor_tpu_torch", "_build")
    if not torch.cuda.is_available():
        for out in (moved, default):
            assert "nvcc" in out["RAISED"]
