"""The yardstick's arithmetic: the frozen roofline copy against the
program's floor today, and the trace reduction (families, the union of
device intervals, idle gaps)."""

import os

import pytest

from tnbench import devtrace, manifest, roofline, traffic


def _compiled(name):
    from artensor_tpu_torch import TensorNetworkSimulation
    from artensor_tpu_torch.runtime import executor

    cell = manifest.cell(name)
    n, layers = traffic.circuit(cell.config, 0)
    sim = TensorNetworkSimulation.from_circuit(
        (n, layers), traffic.bitstrings(cell.traffic, n))
    sim.load_plan(cell.plan_path)
    run_steps, _ = executor.precompute_static_steps(
        sim.steps, [sim.tensors[i] for i in range(len(sim.tensors))],
        sim.slicing_axes)
    return run_steps


@pytest.mark.parametrize("name", ["sparse-1k", "dense-state"])
def test_frozen_roofline_equals_the_programs(name):
    from artensor_tpu_torch.runtime import metrics

    steps = _compiled(name)
    kinds = {type(s.lane).__name__ for s in steps if s.lane is not None}
    assert "GKPlan" in kinds
    want = metrics.scheme_roofline_seconds(steps)
    got = roofline.scheme_roofline_seconds(steps)
    assert got == pytest.approx(want, rel=1e-12)
    assert got > 0


def test_frozen_constants_equal_the_programs():
    from artensor_tpu_torch import kernels
    from artensor_tpu_torch.planner import cost

    assert roofline.HBM_BYTES_PER_S == kernels.H100_HBM_BYTES_PER_S
    assert roofline.TF32_FLOP_PER_S == kernels.H100_TF32_FLOP_PER_S
    assert roofline.MMA_K_STEP == cost.MMA_K_STEP
    assert cost.STEP_OVERHEAD_S == 0.0


def test_families_copied_from_the_profiler_script():
    import ast

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "profile_torch_port.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    node = next(n for n in tree.body if isinstance(n, ast.Assign)
                and n.targets[0].id == "FAMILIES")
    assert ast.literal_eval(node.value) == devtrace.FAMILIES
    assert devtrace.family("void gk_wgmma_kernel<...>") == \
        "gatherk.cu (GK mma)"
    assert devtrace.family("ampere_sgemm_128x64_nn") == \
        "cuBLAS/CUTLASS matmul (dot fallback)"
    assert devtrace.family("something") == "other"
    assert set(devtrace.WGMMA + devtrace.DOT + devtrace.COPIES) <= \
        {f for f, _ in devtrace.FAMILIES}


def test_union_counts_overlaps_once():
    assert devtrace.union_seconds([]) == 0
    assert devtrace.union_seconds([(0, 2), (1, 3), (5, 6)]) == 4
    assert devtrace.union_seconds([(0, 10), (2, 3), (4, 5)]) == 10
    assert devtrace.gaps([(0, 2), (1, 3), (5, 6), (6, 7)]) == [(3, 5)]


def test_summarize_busy_families_and_gaps():
    events = [  # (name, start_us, end_us, on_device)
        ("tnbench.batch", 0, 1000, False),
        ("gk_wgmma_kernel", 100, 400, True),
        ("pair_wgmma_kernel", 300, 500, True),     # overlaps the first
        ("copy_kernel", 700, 800, True),
        ("sgemm", 900, 950, True),
    ]
    tr = devtrace.summarize(events, window_s=0.001, batches=2)
    assert tr["busy_s"] == pytest.approx(550e-6)
    assert tr["family_s"]["gatherk.cu (GK mma)"] == pytest.approx(300e-6)
    assert devtrace.per_batch_ms(tr, devtrace.WGMMA) == pytest.approx(0.25)
    assert devtrace.per_batch_ms(tr, devtrace.DOT) == pytest.approx(0.025)
    assert devtrace.per_batch_ms(tr, ("lane.cu (Lane)",)) is None
    assert tr["device_ops"][0] == ["gk_wgmma_kernel", pytest.approx(3e-4)]
    assert [g[0] for g in tr["idle_gaps"]] == ["tnbench.batch"] * 2
    assert tr["idle_gaps"][0][1] == pytest.approx(200e-6)
    assert devtrace.summarize([("tnbench.batch", 0, 9, False)], 1, 1) \
        is None
