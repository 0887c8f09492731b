"""Make the port's dense n30 m14 plan with the JAX planner (run on the CPU).

The dense workload is the whole 2^30-amplitude state of
``random_circuit(5, 6, 14, seed=0)``: the circuit's
``simplify('normal')`` network, planned by ``artensor_tpu``'s
``find_order`` at ``sc_target`` 30 with ``max_bitstrings`` 1 and the
sparse plans' trials (2) and iterations (10), saved with
``artensor_tpu.plan_io.save_plan`` as
``artensor_tpu_torch/data/rcs_n30_m14_s0_dense_sc30.json``.

No amplitude fixture is made: the amplitudes do not depend on the plan,
so the dense state is held, at the committed bitstrings, to the sparse
workloads' fixtures (``rcs_n30_m14_s0_amps1000.txt`` and
``amps10000.txt``).

Usage (from the repo root)::

    PYTHONHASHSEED=0 JAX_PLATFORMS=cpu \
        python scripts/make_torch_port_dense_plan.py

The JAX planner's output depends on ``PYTHONHASHSEED`` and on the planner
runs made before it in the process, so the committed plan is reproduced
only under the hash seed ``HASH_SEED`` and in a fresh process.  The
script prints the plan's ``complexity()`` and the default scheme's census
and modeled peaks (``metrics.scheme_peak_live_bytes`` and
``scheme_device_peak_bytes``) as the port compiles them.

This script may import ``artensor_tpu``; the port never does.
"""

import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
PLAN = os.path.join(ROOT, "artensor_tpu_torch", "data",
                    "rcs_n30_m14_s0_dense_sc30.json")
SC_TARGET = 30
HASH_SEED = 0     # the PYTHONHASHSEED that gave the committed plan


def make_plan(path=PLAN):
    from artensor_tpu import plan_io
    from artensor_tpu.circuits import TensorNetworkCircuit
    from artensor_tpu.circuits.random_circuits import random_circuit
    from artensor_tpu.network import NumericalTensorNetwork
    from artensor_tpu.planner import find_order

    if os.environ.get("PYTHONHASHSEED") != str(HASH_SEED):
        print(f"warning: the committed plan was made under PYTHONHASHSEED="
              f"{HASH_SEED}", file=sys.stderr)
    circ = TensorNetworkCircuit(random_circuit(5, 6, 14, seed=0))
    ntn = NumericalTensorNetwork(*circ.to_numerical_tn())
    tb2, fq2 = ntn.simplify("normal")
    t0 = time.time()
    _, sliced, ctree = find_order(tb2, ntn.bond_dims, fq2,
                                  max_bitstrings=1, sc_target=SC_TARGET,
                                  trials=2, iters=10, parallel=False)
    plan_io.save_plan(path, ctree, meta={"sc_target": SC_TARGET,
                                         "mode": "dense"})
    print(f"plan: {len(sliced)} sliced bonds {sliced}, complexity "
          f"{ctree.complexity()}, {time.time() - t0:.1f} s -> {path}")


def census(path=PLAN):
    """The port's off and default schemes of the plan: steps after the
    static folds, kernel kinds, compile seconds and the modeled peak."""
    from artensor_tpu_torch import TensorNetworkSimulation, random_circuit
    from artensor_tpu_torch.runtime import executor as ex
    from artensor_tpu_torch.runtime import metrics, scheme
    from artensor_tpu_torch.runtime.scheme import contraction_scheme
    from artensor_tpu_torch.runtime.sparse import kernel_kind

    sim = TensorNetworkSimulation.from_circuit(random_circuit(5, 6, 14,
                                                              seed=0))
    for form in ("off", "default"):
        t0 = time.time()
        sim.load_plan(path)
        if form == "off":
            t0 = time.time()
            sim._set_scheme(*contraction_scheme(sim.ctree, fuse=False,
                                                negotiate=False))
        dt = time.time() - t0
        run_steps, arrays = ex.precompute_static_steps(
            sim.steps, [sim.tensors[i] for i in range(len(sim.tensors))],
            sim.slicing_axes)
        kinds = {}
        for s in run_steps:
            k = kernel_kind(s) or "dot"
            kinds[k] = kinds.get(k, 0) + 1
        pre = sum(1 for s in run_steps
                  if kernel_kind(s) == "gk" and s.lane.pre is not None)
        peak = metrics.scheme_peak_live_bytes(run_steps,
                                              slicing_axes=sim.slicing_axes)
        dev = metrics.scheme_device_peak_bytes(run_steps, 1,
                                               sim.slicing_axes)
        staged = sum(8 * a.size for a in arrays)
        print(f"{form}: compile {dt:.2f} s ({scheme.compile_stats()}); "
              f"{len(sim.steps)} steps, {len(run_steps)} on the device "
              f"{kinds} ({pre} pre-permuted GK); modeled live set "
              f"{peak / 2**30:.3f} GiB, device peak {dev / 2**30:.4f} GiB "
              f"(with the dot's operand copies and the GK tables) + staged "
              f"{staged / 2**30:.3f} GiB")


if __name__ == "__main__":
    if "--census" not in sys.argv:
        make_plan()
    census()
