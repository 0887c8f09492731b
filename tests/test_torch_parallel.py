"""The port's multi-device layer (``parallel/``, ``segmented.
run_segmented_sharded``, ``contraction(mesh=...)``,
``contraction_output_sharded``, the fields' collectives) against the JAX
package's meshes on the conftest's 8 virtual CPU devices, and against
``state_vec``.  The port's replicas are CPU devices
(``make_mesh(devices=[cpu] * n)``).  Tolerances: complex128 1e-12 against
JAX (its own sharded tests hold its meshes to that) and 1e-10 against
``state_vec``; complex64 2e-5 x max|ref|."""

import os

import numpy as np
import pytest
import torch

from artensor_tpu import parallel as jpar
from artensor_tpu import plan_io as jplan_io
from artensor_tpu.circuits import TensorNetworkCircuit as JaxCircuit
from artensor_tpu.circuits.random_circuits import random_circuit
from artensor_tpu.network import NumericalTensorNetwork as JaxNTN
from artensor_tpu.ops.field import make_field as jax_make_field
from artensor_tpu.planner import find_order
from artensor_tpu.runtime import executor as jex
from artensor_tpu_torch import TensorNetworkSimulation, parallel
from artensor_tpu_torch import simulation as psim
from artensor_tpu_torch.ops.field import make_field
from artensor_tpu_torch.runtime import executor as pex
from artensor_tpu_torch.runtime import segmented as pseg

from test_torch_rescaled import off_form_sims

CPU = torch.device("cpu")
JAX_TOL = 1e-12         # complex128, port against JAX
EXACT_TOL = 1e-10       # complex128, against state_vec
C64_TOL = 2e-5          # complex64, of max|ref|
N12 = os.path.join(os.path.dirname(__file__), "data", "circuit_n12_rcs.qsim")
PLAN_KW = dict(trials=2, iters=5, betas=np.linspace(3, 21, 10),
               slicing_repeat=1, parallel=False)


def cpu_mesh(n):
    return parallel.make_mesh(devices=[CPU] * n)


@pytest.fixture(scope="module")
def sparse32():
    """tests/test_runtime.py:247-299: random_circuit(3, 3, 6, seed=21), 40
    bitstrings, a JAX plan at sc_target 6 sliced up to 5 bonds (32
    slices, which 5 replicas share unevenly); both packages' off-form
    simulations and the exact amplitudes."""
    n, layers = random_circuit(3, 3, 6, seed=21)
    rng = np.random.default_rng(3)
    bits = [np.binary_repr(b, n) for b in rng.choice(2 ** n, 40,
                                                      replace=False)]
    ntn = JaxNTN(*JaxCircuit((n, layers)).to_numerical_tn())
    tb2, fq2 = ntn.simplify("sparse")
    _, _, ctree = find_order(tb2, ntn.bond_dims, fq2, max_bitstrings=40,
                             sc_target=6, **PLAN_KW)
    while len(ctree.tn.sliced) < 5:
        ctree.slicing(sorted(ctree.slice_candidates(), key=str)[0])
    plan = jplan_io.plan_to_dict(ctree, meta={"sc_target": 6})
    js, ps = off_form_sims(n, layers, bits, plan)
    assert len(ps.slicing_bonds) == 5
    full = JaxCircuit((n, layers)).state_vec().reshape(-1)
    return dict(js=js, ps=ps, n=n, layers=layers, bits=bits, plan=plan,
                exact={b: full[int(b, 2)] for b in bits})


@pytest.fixture(scope="module")
def closed12():
    """tests/test_runtime.py:96-111: the closed n12 amplitude
    (``tests/data/circuit_n12_rcs.qsim``, final state 000101111011), a
    JAX plan at sc_target 8 with at least 8 slices; both packages' dense
    steps (off form), slicing axes and staged tensors."""
    from artensor_tpu.runtime.scheme import contraction_scheme as jcs
    from artensor_tpu_torch import TensorNetworkCircuit, plan_from_dict
    from artensor_tpu_torch.network import NumericalTensorNetwork
    from artensor_tpu_torch.runtime.scheme import contraction_scheme

    final = "000101111011"
    jc = JaxCircuit(N12, final_state=final)
    jn = JaxNTN(*jc.to_numerical_tn())
    jtb, _ = jn.simplify("normal")
    _, sliced, ctree = find_order(jtb, jn.bond_dims, [], sc_target=8,
                                  **PLAN_KW)
    while 2 ** len(ctree.tn.sliced) < 8:
        ctree.slicing(sorted(ctree.slice_candidates(), key=str)[0])
    sliced = list(ctree.tn.sliced)
    plan = jplan_io.plan_to_dict(ctree)
    jsteps, _ = jcs(ctree, fuse=False, negotiate=False)
    jf = jax_make_field(np.complex128, "highest", "split")
    pn = NumericalTensorNetwork(
        *TensorNetworkCircuit(N12, final_state=final).to_numerical_tn())
    ptb, _ = pn.simplify("normal")
    _, psliced, pctree = plan_from_dict(plan)
    psteps, _ = contraction_scheme(pctree, fuse=False, negotiate=False)
    pf = make_field(np.complex128)
    return dict(
        k=len(sliced), want=complex(jc.state_vec()), jf=jf, pf=pf,
        jsteps=jsteps, jaxes=jex.build_slicing_axes(jtb, sliced),
        jarrays=jex.stage_tensors(jf, [jn.tensors[i]
                                       for i in range(len(jn.tensors))]),
        psteps=psteps, paxes=pex.build_slicing_axes(ptb, list(psliced)),
        parrays=pex.stage_tensors(pf, [pn.tensors[i]
                                       for i in range(len(pn.tensors))],
                                  CPU))


def _jax_sliced(js, n_dev):
    """JAX's ``run_sliced_contraction`` over ``make_mesh(n_dev)`` of a
    simulation's steps, amplitudes keyed by bitstring."""
    from artensor_tpu.runtime.sparse import execute_sparse

    jf = jax_make_field(np.complex128, "highest", "split")
    steps, host = jex.precompute_static_steps(
        js.steps, [js.tensors[i] for i in range(len(js.tensors))],
        js.slicing_axes)
    out_shape = (len(js.bitstrings_sorted),) + (2,) * len(js.output_bonds)
    res = jpar.run_sliced_contraction(
        jex.stage_tensors(jf, host), steps, js.slicing_axes,
        len(js.slicing_bonds), out_shape, jpar.make_mesh(n_dev), field=jf,
        execute=execute_sparse)
    amps = jf.unwrap(res).reshape(out_shape).transpose(js.permute_dims)
    return dict(zip(js.bitstrings_sorted, amps.reshape(-1)))


def _port_sliced(ps, mesh, dtype=np.complex128, slice_batch=1):
    field, steps, arrays, out_shape, execute, _ = ps._staged(
        CPU, make_field(dtype))
    res = parallel.run_sliced_contraction(
        arrays, steps, ps.slicing_axes, len(ps.slicing_bonds), out_shape,
        mesh, field=field, execute=execute, slice_batch=slice_batch)
    amps = field.unwrap(res).reshape(out_shape).transpose(ps.permute_dims)
    return dict(zip(ps.bitstrings_sorted, amps.reshape(-1)))


def _close(got, want, tol):
    assert set(got) == set(want)
    worst = max(abs(got[b] - want[b]) for b in want)
    assert worst <= tol, worst


@pytest.mark.parametrize("n", [1, 5, 8])
def test_sliced_sparse_matches_jax_mesh(sparse32, n):
    """32 slices over n replicas (uneven over 5) against JAX's mesh of
    the same size (JAX pads and masks the ids, the port partitions them),
    JAX's single-device run and ``state_vec``."""
    got = _port_sliced(sparse32["ps"], cpu_mesh(n))
    _close(got, _jax_sliced(sparse32["js"], n), JAX_TOL)
    _close(got, _jax_sliced(sparse32["js"], 1), JAX_TOL)
    _close(got, sparse32["exact"], EXACT_TOL)
    reps = parallel.LAST_RUN["replicas"]
    assert [r["slices"] for r in reps] == \
        [len(range(d * 32 // n, (d + 1) * 32 // n)) for d in range(n)]
    assert [r["first_slice"] for r in reps] == [d * 32 // n
                                               for d in range(n)]


@pytest.mark.parametrize("width", [2, 4])
def test_sliced_sparse_width_per_replica(sparse32, width):
    """Each replica runs its range at the width asked for, the rest of an
    uneven range as one narrower group; complex64 against JAX's
    complex128 mesh."""
    got = _port_sliced(sparse32["ps"], cpu_mesh(5), np.complex64, width)
    want = _jax_sliced(sparse32["js"], 5)
    scale = max(abs(v) for v in want.values())
    _close(got, want, C64_TOL * scale)
    assert all(r["slice_batch"] == width
               for r in parallel.LAST_RUN["replicas"])


@pytest.mark.parametrize("n", [1, 5, 8, 11])
def test_sliced_dense_matches_jax_mesh(closed12, n):
    """The closed n12 amplitude (a scalar; at least 8 slices) over n
    replicas against JAX's ``run_sliced_contraction(make_mesh(min(n,
    8)))`` and ``state_vec``; 11 replicas outnumber the slices there, and
    a replica with no slice launches nothing."""
    c = closed12
    got = complex(c["pf"].unwrap(parallel.run_sliced_contraction(
        c["parrays"], c["psteps"], c["paxes"], c["k"], (), cpu_mesh(n),
        field=c["pf"])))
    want = complex(c["jf"].unwrap(jpar.run_sliced_contraction(
        c["jarrays"], c["jsteps"], c["jaxes"], c["k"], (),
        jpar.make_mesh(min(n, 8)), field=c["jf"])))
    assert abs(got - want) < JAX_TOL
    assert abs(got - c["want"]) < EXACT_TOL
    total = 2 ** c["k"]
    assert len(parallel.LAST_RUN["replicas"]) == min(n, total)
    assert sum(r["slices"] for r in parallel.LAST_RUN["replicas"]) == total


def test_nothing_sliced_runs_once_on_the_first_replica():
    """With no sliced bond the run is made once, by replica 0."""
    n, layers = random_circuit(2, 3, 6, seed=31)
    sim = TensorNetworkSimulation.from_circuit((n, layers))
    sim.prepare_contraction(sc_target=30, **PLAN_KW)
    assert not sim.slicing_bonds
    got = sim.contraction(dtype=np.complex128, mesh=cpu_mesh(3))
    assert [r["first_slice"] for r in parallel.LAST_RUN["replicas"]] == [0]
    assert sim.run_stats["executor"] == "mesh"
    want = JaxCircuit((n, layers)).state_vec()
    assert np.abs(got - want).max() < EXACT_TOL


def _open_sims(seed, n_rows=2, n_cols=3, cycles=6, sc_target=6, d_out=None):
    """The JAX and the port simulation of one dense open circuit
    (tests/test_runtime.py:329), the port's loading JAX's plan; with
    ``d_out`` both plan the blocks (``prepare_output_sharded``) apart."""
    from artensor_tpu.simulation import TensorNetworkSimulation as JaxSim

    n, layers = random_circuit(n_rows, n_cols, cycles, seed=seed)
    js = JaxSim.from_circuit(JaxCircuit((n, layers)), bitstrings=())
    ps = TensorNetworkSimulation.from_circuit((n, layers))
    if d_out is None:
        js.prepare_contraction(sc_target=sc_target, **PLAN_KW)
        ps.load_plan(jplan_io.plan_to_dict(js.ctree))
    else:
        for s in (js, ps):
            s.prepare_output_sharded(d_out, sc_target=sc_target, **PLAN_KW)
    return n, js, ps, JaxCircuit((n, layers)).state_vec()


@pytest.mark.parametrize("n,d_out", [(8, None), (4, 2), (2, 3)])
def test_output_sharded_post_hoc_matches_jax(n, d_out):
    n_q, js, ps, want = _open_sims(31)
    got = ps.contraction_output_sharded(cpu_mesh(n), d_out=d_out,
                                        dtype=np.complex128)
    jfull = js.contraction_output_sharded(jpar.make_mesh(n), d_out=d_out,
                                          dtype=np.complex128)
    assert got.shape == (2,) * n_q
    assert np.abs(got - jfull).max() < JAX_TOL
    assert np.abs(got - want).max() < EXACT_TOL
    reps = parallel.LAST_RUN["replicas"]
    blocks = 2 ** (d_out or 3)
    assert [r["blocks"] for r in reps] == [blocks // n] * n
    # the legs sliced post hoc are put back: the plain run still works
    plain = ps.contraction(dtype=np.complex128, device="cpu")
    assert np.abs(plain - want).max() < EXACT_TOL


def test_output_sharded_preplanned_matches_jax():
    """tests/test_runtime.py:417-440: ``prepare_output_sharded(3)`` in
    both packages, the planned blocks over 8 replicas."""
    n_q, js, ps, want = _open_sims(33, sc_target=5, d_out=3)
    got = ps.contraction_output_sharded(cpu_mesh(8), d_out=3,
                                        dtype=np.complex128)
    jfull = js.contraction_output_sharded(jpar.make_mesh(8), d_out=3,
                                          dtype=np.complex128)
    assert np.abs(got - jfull).max() < JAX_TOL
    assert np.abs(got - want).max() < EXACT_TOL


def test_run_output_sharded_keeps_blocks_on_their_replicas():
    """One stacked tensor a replica, its blocks in order: together the
    state in the block scheme's order; blocks that do not divide over
    the replicas raise."""
    n_q, _, ps, want = _open_sims(31)
    field = make_field(np.complex128)
    steps, axes, chosen, out_bonds, k, restore = psim._dense_shard_setup(
        ps, 2)
    try:
        steps, host = pex.precompute_static_steps(
            steps, [ps.tensors[i] for i in range(len(ps.tensors))], axes)
        staged = pex.stage_tensors(field, host, CPU)
        local = (2,) * len(out_bonds)
        parts = parallel.run_output_sharded(staged, steps, axes, 2, k,
                                            local, cpu_mesh(2), field=field)
        with pytest.raises(ValueError, match="do not divide"):
            parallel.run_output_sharded(staged, steps, axes, 2, k, local,
                                        cpu_mesh(3), field=field)
    finally:
        restore()
    assert len(parts) == 2
    for p in parts:
        assert all(c.shape[0] == 2 and c.device == CPU
                   for c in field.buffers(p))
    got = np.concatenate([field.unwrap(p).reshape(-1) for p in parts])
    got = got.reshape((2,) * 2 + local).transpose(
        psim._dense_shard_perm(chosen, out_bonds))
    assert np.abs(got - want).max() < EXACT_TOL


def test_segmented_sharded_matches_jax():
    """tests/test_aux.py:394-417: the sparse scheme of random_circuit(3,
    3, 6, seed=13) (60 bitstrings, sc_target 6) over 5 replicas at 9
    steps a segment and width 2, against JAX's ``run_segmented_sharded``
    over 5 devices and its whole-group run."""
    import jax

    from artensor_tpu.runtime.segmented import \
        apply_sparse_step as japply
    from artensor_tpu.runtime.segmented import \
        run_segmented_sharded as jrun
    from artensor_tpu.runtime.sparse import execute_sparse

    n, layers = random_circuit(3, 3, 6, seed=13)
    rng = np.random.default_rng(5)
    bits = [np.binary_repr(b, n) for b in rng.choice(2 ** n, 60,
                                                      replace=False)]
    ntn = JaxNTN(*JaxCircuit((n, layers)).to_numerical_tn())
    tb2, fq2 = ntn.simplify("sparse")
    _, sliced, ctree = find_order(tb2, ntn.bond_dims, fq2, max_bitstrings=60,
                                  sc_target=6, **PLAN_KW)
    assert len(sliced) >= 3
    js, ps = off_form_sims(n, layers, bits,
                           jplan_io.plan_to_dict(ctree,
                                                 meta={"sc_target": 6}))
    jf = jax_make_field(np.complex128, "highest", "split")
    staged = jex.stage_tensors(jf, [js.tensors[i]
                                    for i in range(len(js.tensors))])
    out = (len(js.bitstrings_sorted),)
    k = len(js.slicing_bonds)
    want = jf.unwrap(jrun(staged, js.steps, js.slicing_axes, k, out, jf,
                          japply, jax.devices()[:5], segment_steps=9,
                          slice_batch=2)).reshape(-1)
    mono = jf.unwrap(jax.jit(jex.make_sliced_runner(
        execute_sparse, js.steps, js.slicing_axes, k, out, jf))(staged))
    field, steps, arrays, out_shape, _, step = ps._staged(
        CPU, make_field(np.complex128))
    got = field.unwrap(pseg.run_segmented_sharded(
        arrays, steps, ps.slicing_axes, k, out_shape, field, step,
        [CPU] * 5, segment_steps=9, slice_batch=2)).reshape(-1)
    assert ps.bitstrings_sorted == js.bitstrings_sorted
    assert np.abs(got - want).max() < JAX_TOL
    assert np.abs(got - mono.reshape(-1)).max() < JAX_TOL
    reps = pseg.LAST_RUN["replicas"]
    assert [r["slices"] for r in reps] == \
        [len(range(d * 2 ** k // 5, (d + 1) * 2 ** k // 5))
         for d in range(5)]
    assert all(r["segments"] == -(-len(steps) // 9) for r in reps)


def test_dispatch_batches_round_robin_all_launched_before_any_wait():
    """tests/test_runtime.py:305 as a pattern: group g runs on devices[g
    % n]; every group is built and launched (its callable called) before
    any group's run is waited on, and the results come back in group
    order."""
    events = []

    def make_runner(scale):
        def runner(dev):
            events.append(("launch", scale, dev))
            x = torch.arange(16.0, device=dev) * scale

            def run():
                events.append(("wait", scale, dev))
                return (x * x).sum()
            return run
        return runner

    devices = [torch.device("cpu"), torch.device("meta")]
    res = parallel.dispatch_batches(make_runner, [1.0, 2.0, 3.0, 4.0],
                                    devices)
    kinds = [e[0] for e in events]
    assert kinds == ["launch"] * 4 + ["wait"] * 4
    assert [e[2] for e in events[:4]] == [devices[g % 2] for g in range(4)]
    assert [r.device for r in res] == [devices[g % 2] for g in range(4)]
    want = float((torch.arange(16.0) ** 2).sum())
    assert [float(r) for r in res[::2]] == [want, want * 9]


def test_a_failing_replica_fails_the_call(sparse32, monkeypatch):
    """An error in one replica's run is raised by the mesh run; nothing
    is summed past it."""
    calls = []
    real = pex.make_sliced_runner

    def flaky(*a, **k):
        run = real(*a, **k)

        def wrapped(tensors, slice_ids=None, init=None):
            calls.append(slice_ids)
            if len(calls) == 2:
                raise RuntimeError("replica 1 failed")
            return run(tensors, slice_ids, init)
        wrapped.capture, wrapped.stats = run.capture, run.stats
        return wrapped

    monkeypatch.setattr(parallel, "make_sliced_runner", flaky)
    with pytest.raises(RuntimeError, match="replica 1 failed"):
        _port_sliced(sparse32["ps"], cpu_mesh(3))


def test_contraction_mesh_routing(sparse32, tmp_path, monkeypatch):
    """``contraction(mesh=...)`` in JAX's order: scientific notation before
    the mesh, the mesh before a checkpoint (no file is written), and a
    scheme above ``SEGMENT_AUTO_THRESHOLD`` steps runs segmented over the
    replicas; each equals JAX's mesh run.  A mesh with a device raises."""
    ps, mesh = sparse32["ps"], cpu_mesh(3)
    want = _jax_sliced(sparse32["js"], 3)
    keyed = lambda a: dict(zip(ps.bitstrings_sorted, a))
    amps, factor = ps.contraction(dtype=np.complex128, mesh=mesh,
                                  scientific_notation=True)
    assert ps.run_stats["executor"] == "rescaled"
    _close(keyed(amps * 10.0 ** factor), want, EXACT_TOL)
    ckpt = str(tmp_path / "ckpt.npz")
    got = ps.contraction(dtype=np.complex128, mesh=mesh,
                         checkpoint_path=ckpt)
    st = ps.run_stats
    assert st["executor"] == "mesh" and not os.path.exists(ckpt)
    assert len(st["replicas"]) == 3 and st["slice_batch"] == 1
    assert st["replays"] == 0 and st["captures"] == 0   # CPU: eager
    _close(keyed(got), want, JAX_TOL)
    monkeypatch.setattr(psim, "SEGMENT_AUTO_THRESHOLD", 2)
    got = ps.contraction(dtype=np.complex128, mesh=mesh, slice_batch=2)
    st = ps.run_stats
    assert st["executor"] == "segmented-sharded"
    assert [r["device"] for r in st["replicas"]] == ["cpu"] * 3
    _close(keyed(got), want, JAX_TOL)
    with pytest.raises(ValueError, match="names its devices"):
        ps.contraction(mesh=mesh, device="cpu")


@pytest.mark.parametrize("entry", ["tensor_network_contraction",
                                   "quantum_circuit_simulation"])
def test_one_shots_take_a_mesh(entry):
    """The one-shots plan, compile and run over a mesh (sc_target 5: the
    plan slices), against ``state_vec``."""
    import artensor_tpu_torch as port

    n, layers = random_circuit(2, 3, 6, seed=2)
    bits = [np.binary_repr(b, n) for b in range(0, 2 ** n, 5)]
    kw = dict(sc_target=5, trial_num=2, iters=5, parallel=False,
              dtype=np.complex128, mesh=cpu_mesh(4))
    if entry == "tensor_network_contraction":
        tn = port.TensorNetworkCircuit((n, layers)).to_numerical_tn()
        amps, got_bits = port.tensor_network_contraction(*tn, bits, **kw)
    else:
        amps, got_bits = port.quantum_circuit_simulation((n, layers), bits,
                                                         **kw)
    full = JaxCircuit((n, layers)).state_vec().reshape(-1)
    want = np.array([full[int(b, 2)] for b in got_bits])
    assert sorted(got_bits) == sorted(bits)
    assert np.abs(np.asarray(amps).reshape(-1) - want).max() < EXACT_TOL


@pytest.mark.parametrize("mode", ["split", "complex", "fused"])
def test_psum_over_a_group_of_one(tmp_path, mode):
    """``psum`` over a gloo group of one process, or over no group, gives
    its value back as it is; ``pvary`` is the identity."""
    import torch.distributed as dist

    field = make_field(np.complex64, mode=mode)
    x = field.wrap(np.arange(6).reshape(2, 3) * (1 + 2j), "cpu")
    assert field.psum(x) is x and field.pvary(x, "slice") is x
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rdv",
                            rank=0, world_size=1)
    try:
        assert field.psum(x, dist.group.WORLD) is x
    finally:
        dist.destroy_process_group()
    np.testing.assert_array_equal(field.unwrap(x),
                                  np.arange(6).reshape(2, 3) * (1 + 2j))


def test_no_card_no_fallback():
    """Without a card the mesh entry points at their default device raise:
    ``make_mesh()``, ``dispatch_batches`` over every card, the global
    mesh outside a process group; a mesh never shrinks."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from artensor_tpu_torch.parallel import distributed

    with pytest.raises(RuntimeError, match="CUDA"):
        parallel.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        parallel.make_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        parallel.dispatch_batches(lambda p: None, [1])
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed.global_mesh()
    with pytest.raises(ValueError, match="3 devices"):
        parallel.make_mesh(3, devices=[CPU, CPU])
    m = parallel.make_mesh(2, devices=[CPU] * 4)
    assert m.devices == (CPU, CPU) and m.n_replicas == 2

