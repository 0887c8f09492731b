"""The port across processes (``parallel/distributed.py``): two and three
worker processes on the CPU, joined by ``initialize(backend="gloo")``
through the ``ARTENSOR_*`` environment, each running its share of the
slices of tests/test_distributed.py's circuit (random_circuit(3, 3, 6,
seed=21), 24 bitstrings, 4 sliced bonds: 16 slices, uneven over three
processes) on the plan the parent makes with JAX and writes with
``save_plan``.  The workers import no JAX.  Every rank's sum must equal
JAX's ``run_sliced_contraction(make_mesh(8))`` within 1e-12 and
``state_vec`` within 1e-10 (complex128), and ``psum`` of each field must
sum the ranks' values exactly."""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from artensor_tpu import parallel as jpar
from artensor_tpu import plan_io as jplan_io
from artensor_tpu.circuits import TensorNetworkCircuit as JaxCircuit
from artensor_tpu.circuits.random_circuits import random_circuit
from artensor_tpu.network import NumericalTensorNetwork as JaxNTN
from artensor_tpu.ops.field import make_field as jax_make_field
from artensor_tpu.planner import find_order
from artensor_tpu.runtime import executor as jex
from artensor_tpu.runtime.sparse import (contraction_scheme_sparse,
                                         execute_sparse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOL = 1e-12
EXACT_TOL = 1e-10
PROC_TIMEOUT = 120      # seconds, each worker process

WORKER = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch
    sys.path.insert(0, {repo!r})
    from artensor_tpu_torch import TensorNetworkSimulation, random_circuit
    from artensor_tpu_torch.ops.field import make_field
    from artensor_tpu_torch.parallel import distributed as dist

    assert dist.initialize(backend="gloo", local_device_ids=["cpu"])
    rank = int(os.environ["ARTENSOR_PROC_ID"])
    mesh = dist.global_mesh()
    assert mesh.size == int(os.environ["ARTENSOR_NUM_PROCS"])
    assert mesh.rank == rank and mesh.devices == (torch.device("cpu"),)
    with open(os.environ["BITS_FILE"]) as f:
        bits = json.load(f)
    sim = TensorNetworkSimulation.from_circuit(
        random_circuit(3, 3, 6, seed=21), bits)
    sim.load_plan(os.environ["PLAN_FILE"])
    field = make_field(np.complex128)
    if os.environ["ENTRY"] == "contraction":
        amps = sim.contraction(dtype=np.complex128, mesh=mesh)
        assert sim.run_stats["executor"] == "mesh"
    else:
        f, steps, arrays, out_shape, execute, _ = sim._staged(
            torch.device("cpu"), field)
        res = dist.run_sliced_distributed(
            arrays, steps, sim.slicing_axes, len(sim.slicing_bonds),
            out_shape, mesh, field=f, execute=execute)
        amps = f.unwrap(res).reshape(out_shape).transpose(sim.permute_dims)
    from artensor_tpu_torch import parallel
    mine = [r["slices"] for r in parallel.LAST_RUN["replicas"]]
    sums = {{}}
    for mode in ("split", "complex", "fused"):
        fm = make_field(np.complex64, mode=mode)
        x = fm.wrap(np.arange(6).reshape(2, 3) * (rank + 1) * (1 + 2j),
                    "cpu")
        sums[mode] = fm.unwrap(fm.psum(x, mesh.group)).tolist()
    bad = sorted(m for m in sys.modules if m.split(".")[0] in
                 ("jax", "artensor_tpu"))
    np.save(os.environ["OUT"] + f".{{rank}}.npy", np.asarray(amps))
    with open(os.environ["OUT"] + f".{{rank}}.json", "w") as f:
        json.dump(dict(bits=sim.bitstrings_sorted, slices=mine, bad=bad,
                       sums={{k: [[[z.real, z.imag] for z in row]
                                  for row in v] for k, v in sums.items()}}),
                  f)
""")


@pytest.fixture(scope="module")
def planned(tmp_path_factory):
    """tests/test_distributed.py's plan (JAX ``find_order``, sliced up to 4
    bonds), written by JAX's ``save_plan``; JAX's 8-device mesh result and
    the exact amplitudes, keyed by bitstring."""
    n, layers = random_circuit(3, 3, 6, seed=21)
    rng = np.random.default_rng(3)
    bits = [np.binary_repr(b, n) for b in rng.choice(2 ** n, 24,
                                                      replace=False)]
    ntn = JaxNTN(*JaxCircuit((n, layers)).to_numerical_tn())
    tb2, fq2 = ntn.simplify("sparse")
    _, _, ctree = find_order(
        tb2, ntn.bond_dims, fq2, max_bitstrings=24, sc_target=6, trials=2,
        iters=5, betas=np.linspace(3, 21, 10), slicing_repeat=1,
        parallel=False, start_seed=7)
    while len(ctree.tn.sliced) < 4:
        ctree.slicing(sorted(ctree.slice_candidates(), key=str)[0])
    sliced = list(ctree.tn.sliced)
    d = tmp_path_factory.mktemp("dist")
    plan_file, bits_file = str(d / "plan.json"), str(d / "bits.json")
    jplan_io.save_plan(plan_file, ctree, meta={"sc_target": 6})
    with open(bits_file, "w") as f:
        json.dump(bits, f)
    steps, _, bits_sorted = contraction_scheme_sparse(ctree, bits,
                                                      sc_target=6)
    axes = jex.build_slicing_axes(tb2, sliced, batched_tensors=fq2)
    jf = jax_make_field(np.complex128, "highest", "split")
    arrays = jex.stage_tensors(jf, [ntn.tensors[i]
                                    for i in range(len(ntn.tensors))])
    res = jpar.run_sliced_contraction(arrays, steps, axes, len(sliced),
                                      (len(bits_sorted),), jpar.make_mesh(8),
                                      field=jf, execute=execute_sparse)
    full = JaxCircuit((n, layers)).state_vec().reshape(-1)
    return dict(plan=plan_file, bits=bits_file, k=len(sliced),
                jax=dict(zip(bits_sorted, jf.unwrap(res).reshape(-1))),
                exact={b: full[int(b, 2)] for b in bits})


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(planned, n_procs, entry, out):
    port = _free_port()
    procs = []
    for rank in range(n_procs):
        env = dict(os.environ, ARTENSOR_COORDINATOR=f"127.0.0.1:{port}",
                   ARTENSOR_NUM_PROCS=str(n_procs),
                   ARTENSOR_PROC_ID=str(rank), PLAN_FILE=planned["plan"],
                   BITS_FILE=planned["bits"], OUT=out, ENTRY=entry)
        env.pop("PYTHONPATH", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER.format(repo=REPO)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=PROC_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]


@pytest.mark.parametrize("n_procs,entry", [
    (2, "run_sliced_distributed"), (3, "run_sliced_distributed"),
    (2, "contraction")])
def test_ranks_sum_their_shares(planned, tmp_path, n_procs, entry):
    out = str(tmp_path / "amps")
    _run_workers(planned, n_procs, entry, out)
    total, first = 2 ** planned["k"], None
    shares = []
    for rank in range(n_procs):
        amps = np.load(f"{out}.{rank}.npy").reshape(-1)
        with open(f"{out}.{rank}.json") as f:
            meta = json.load(f)
        assert meta["bad"] == [], meta["bad"]
        got = dict(zip(meta["bits"], amps))
        for want, tol in ((planned["jax"], JAX_TOL),
                          (planned["exact"], EXACT_TOL)):
            assert set(got) == set(want)
            assert max(abs(got[b] - want[b]) for b in want) < tol
        if first is None:
            first = amps
        np.testing.assert_array_equal(amps, first)   # every rank the same
        shares += meta["slices"]
        base = np.arange(6).reshape(2, 3) * (1 + 2j)
        scale = n_procs * (n_procs + 1) // 2
        for mode, v in meta["sums"].items():
            got_sum = np.array([[complex(*z) for z in row] for row in v])
            np.testing.assert_array_equal(got_sum, base * scale)
    assert shares == [len(range(r * total // n_procs,
                                (r + 1) * total // n_procs))
                      for r in range(n_procs)]


def test_initialize_without_environment_is_a_single_process(monkeypatch):
    import torch.distributed as tdist

    from artensor_tpu_torch.parallel import distributed as dist

    for var in ("ARTENSOR_COORDINATOR", "ARTENSOR_NUM_PROCS",
                "ARTENSOR_PROC_ID"):
        monkeypatch.delenv(var, raising=False)
    assert dist.initialize() is False
    assert dist.initialize(num_processes=4) is False   # no coordinator
    assert not tdist.is_initialized()
    if not tdist.is_nccl_available():
        # NCCL is the default and is never switched for gloo
        monkeypatch.setenv("ARTENSOR_COORDINATOR", "127.0.0.1:1")
        monkeypatch.setenv("ARTENSOR_NUM_PROCS", "2")
        with pytest.raises(RuntimeError, match="nccl"):
            dist.initialize()
        assert not tdist.is_initialized()
