"""Make the port's n30 workload data with the JAX package (run on the CPU).

Three workloads of ``random_circuit(5, 6, 14, seed=0)``, chosen by
``--workload``: ``1k`` (the default; 1000 bitstrings, sc_target 24),
``10k`` (10000 bitstrings, sc_target 24) and ``1k-sc25`` (the 1000
bitstrings at sc_target 25).  For each it writes into
``artensor_tpu_torch/data/``:

* the plan (``--plan``): a plan for the circuit's ``simplify('sparse')``
  network with ``max_bitstrings`` the batch size, made by the JAX planner
  and saved with ``artensor_tpu.plan_io.save_plan``
  (``rcs_n30_m14_s0_sparse_sc24.json``,
  ``rcs_n30_m14_s0_sparse10k_sc24.json``,
  ``rcs_n30_m14_s0_sparse_sc25.json``);
* ``rcs_n30_m14_s0_amps<N>.txt``: the amplitudes of the N distinct
  bitstrings ``np.random.default_rng(0).choice(2**30, N, replace=False)``
  (MSB-first, in generator order), one ``bitstring re im`` line each — the
  format of Google's amplitude files.  They are computed from the
  workload's committed plan by the JAX sliced executor, in complex128 on
  the plain XLA path (no Pallas kernels).  The two draws are separate: the
  10000 set does not contain the 1000 set.  The amplitudes do not depend
  on the plan, so ``1k-sc25`` shares the ``1k`` fixture and writes none.

Usage (from the repo root)::

    JAX_PLATFORMS=cpu python scripts/make_torch_port_fixture.py
    PYTHONHASHSEED=6 JAX_PLATFORMS=cpu \
        python scripts/make_torch_port_fixture.py --plan   # re-plan first
    PYTHONHASHSEED=2 JAX_PLATFORMS=cpu \
        python scripts/make_torch_port_fixture.py --workload 10k --plan
    PYTHONHASHSEED=6 JAX_PLATFORMS=cpu \
        python scripts/make_torch_port_fixture.py --workload 1k-sc25 --plan

The JAX planner's output depends on ``PYTHONHASHSEED`` and on the planner
runs made before it in the process, so ``--plan`` reproduces a committed
plan only under the hash seed given above and in a fresh process.

This script may import ``artensor_tpu``; the port never does.
"""

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
DATA = os.path.join(ROOT, "artensor_tpu_torch", "data")
# name: (plan file, n bitstrings, sc_targets planned in order in one
# process — the last is the plan's and the scheme's — and the
# PYTHONHASHSEED that gave the committed plan)
WORKLOADS = {
    "1k": ("rcs_n30_m14_s0_sparse_sc24.json", 1000, (22, 23, 24), 6),
    "10k": ("rcs_n30_m14_s0_sparse10k_sc24.json", 10000, (24,), 2),
    "1k-sc25": ("rcs_n30_m14_s0_sparse_sc25.json", 1000, (22, 23, 24, 25),
                6),
}


def plan_path(workload):
    return os.path.join(DATA, WORKLOADS[workload][0])


def fixture_path(n_bits):
    return os.path.join(DATA, f"rcs_n30_m14_s0_amps{n_bits}.txt")


def bitstrings(n_bits=1000):
    ids = np.random.default_rng(0).choice(2 ** 30, n_bits, replace=False)
    return [np.binary_repr(int(b), 30) for b in ids]


def network():
    from artensor_tpu.circuits import TensorNetworkCircuit
    from artensor_tpu.circuits.random_circuits import random_circuit
    from artensor_tpu.network import NumericalTensorNetwork

    circ = TensorNetworkCircuit(random_circuit(5, 6, 14, seed=0))
    ntn = NumericalTensorNetwork(*circ.to_numerical_tn())
    tb2, fq2 = ntn.simplify("sparse")
    return ntn, tb2, fq2


def make_plan(workload):
    """Repeat the planner sequence of the committed plan: ``1k`` sc_target
    22, 23 and 24 in that order (the first of 24 hash seeds tried whose
    plan the port compiles into all four kernel kinds of its first slice),
    ``10k`` sc_target 24 alone (7 sliced bonds and one RGFlat step under
    hash seed 2), ``1k-sc25`` the ``1k`` sequence and one more target, 25
    (5 sliced bonds and one lane step)."""
    from artensor_tpu import plan_io
    from artensor_tpu.planner import find_order

    _, n_bits, scs, seed = WORKLOADS[workload]
    if os.environ.get("PYTHONHASHSEED") != str(seed):
        print(f"warning: the committed plan was made under PYTHONHASHSEED="
              f"{seed}", file=sys.stderr)
    ntn, tb2, fq2 = network()
    for sc in scs:
        _, sliced, ctree = find_order(tb2, ntn.bond_dims, fq2,
                                      max_bitstrings=n_bits, sc_target=sc,
                                      trials=2, iters=10, parallel=False)
    plan_io.save_plan(plan_path(workload), ctree,
                      meta={"sc_target": scs[-1]})
    print(f"plan: {len(sliced)} sliced bonds {sliced}, complexity "
          f"{ctree.complexity()} -> {plan_path(workload)}")


def make_fixture(workload):
    import jax

    from artensor_tpu import plan_io
    from artensor_tpu.ops.field import make_field
    from artensor_tpu.runtime.executor import (build_slicing_axes,
                                               make_sliced_runner,
                                               stage_tensors)
    from artensor_tpu.runtime.sparse import (contraction_scheme_sparse,
                                             execute_sparse)

    _, n_bits, scs, _ = WORKLOADS[workload]
    jax.config.update("jax_enable_x64", True)
    ntn, tb2, fq2 = network()
    bits = bitstrings(n_bits)
    _, sliced, ctree = plan_io.load_plan(plan_path(workload))
    steps, _, bits_sorted = contraction_scheme_sparse(
        ctree, bits, sc_target=scs[-1], lane_schedule=False)
    field = make_field(np.complex128, "highest", "complex")
    staged = stage_tensors(
        field, [ntn.tensors[i] for i in range(len(ntn.tensors))])
    axes = build_slicing_axes(tb2, sliced, batched_tensors=fq2)
    run = jax.jit(make_sliced_runner(execute_sparse, steps, axes,
                                     len(sliced), (len(bits_sorted),),
                                     field))
    t0 = time.time()
    amps = np.asarray(field.unwrap(run(staged))).reshape(-1)
    by_bits = dict(zip(bits_sorted, amps))
    with open(fixture_path(n_bits), "w") as f:
        for b in bits:
            a = by_bits[b]
            f.write(f"{b} {a.real:.17e} {a.imag:.17e}\n")
    p = (2 ** 30) * np.mean(np.abs(amps) ** 2)
    print(f"fixture: {len(bits)} amplitudes in {time.time() - t0:.1f} s, "
          f"mean 2^n|a|^2 = {p:.4f} -> {fixture_path(n_bits)}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="1k", choices=list(WORKLOADS),
                    help="plan and amplitude batch (default: 1k)")
    ap.add_argument("--plan", action="store_true",
                    help="re-plan and overwrite the committed plan first")
    args = ap.parse_args()
    if args.plan:
        make_plan(args.workload)
    if args.workload == "1k-sc25":
        print(f"fixture: shared with 1k -> {fixture_path(1000)}")
    else:
        make_fixture(args.workload)


if __name__ == "__main__":
    main()
