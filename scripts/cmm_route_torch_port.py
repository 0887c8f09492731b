"""The complex matmul kernel against the dot fallback's cuBLAS products at
every product shape of the benchmark cells' dot steps: the measurement
``ops/pallas_mm.cmm_route`` was set from.

    python3 scripts/cmm_route_torch_port.py [--out PATH] [--seeds N]

First, on the host, each cell of ``BENCHMARK.json`` compiles its frozen
plan as ``tnbench/session.py`` does (``load_plan``, the static folds, the
program's width) and lists the products its dot steps make at that width
(``field.product_dims`` of ``lowering.batched_dnums``): the census.  Then,
on the card, at each distinct (B, M, K, N): the kernel at ``cmm_tile``'s
tile and ``field._split_dot`` (four cuBLAS products at FP32), each timed
by ``chip_smoke.time_ms`` (device time, median), and for ``--seeds``
random inputs the largest error of each against a float64 product on a
slice of the output (``SUB`` rows, or columns, or batch entries): the
ratio of the kernel's to cuBLAS's, pooled over the seeds and per seed.
One JSON line a shape (``--out``, default ``chiprun_out/cmm_route.jsonl``)
with the route's answer beside it, and the card's name and power limit
first.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DN = (((2,), (1,)), ((0,), (0,)))     # (B, M, K) . (B, K, N)
SUB = 1 << 14


def census(name):
    """(width, [(step, B, M, K, N)]) of the cell's dot-step products."""
    from tnbench import manifest, traffic
    from artensor_tpu_torch import TensorNetworkSimulation
    from artensor_tpu_torch.ops.field import product_dims
    from artensor_tpu_torch.runtime import executor, metrics
    from artensor_tpu_torch.runtime.lowering import batched_dnums

    cell = manifest.cell(name)
    n, layers = traffic.circuit(cell.config, 0)
    sim = TensorNetworkSimulation.from_circuit(
        (n, layers), traffic.bitstrings(cell.traffic, n))
    sim.load_plan(cell.plan_path)
    steps, _ = executor.precompute_static_steps(
        sim.steps, [sim.tensors[i] for i in range(len(sim.tensors))],
        sim.slicing_axes)
    k = len(sim.slicing_bonds)
    width = metrics.dividing_slice_width(steps, k, sim.slicing_axes)
    dyn = metrics.slice_dynamic_ids(steps, sim.slicing_axes)
    out = []
    for idx, s in enumerate(steps):
        if getattr(s, "lane", None) is not None:
            continue
        for low in metrics._lows(s):
            ids = (s.j, s.i) if low.swapped else (s.i, s.j)
            bl, br = (k > 0 and width > 1 and t in dyn for t in ids)
            dn, _ = batched_dnums(low, bl, br)
            out.append((idx, *product_dims(
                ((width,) if bl else ()) + tuple(low.shape_l),
                ((width,) if br else ()) + tuple(low.shape_r), dn)))
    return width, out


def operands(B, M, K, N, seed):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = tuple(torch.randn((B, M, K), generator=gen, device="cuda")
              for _ in "ri")
    b = tuple(torch.randn((B, K, N), generator=gen, device="cuda")
              for _ in "ri")
    return a, b


def f64_errors(a, b, ys, B, M, N):
    """The largest |y - float64| of each output pair in ``ys`` on a slice
    of the product: the first batch entries, rows or columns."""
    import torch

    from artensor_tpu_torch.ops.pallas_mm import complex_batched_matmul_plain

    if B > 64:
        cut, sa, sb = (slice(0, 64),), [t[:64] for t in a], \
            [t[:64] for t in b]
    elif M >= N:
        r = min(M, max(1, SUB // B))
        cut, sa, sb = (slice(None), slice(0, r)), [t[:, :r] for t in a], b
    else:
        c = min(N, max(1, SUB // B))
        cut = (slice(None), slice(None), slice(0, c))
        sa, sb = a, [t[:, :, :c] for t in b]
    ref = torch.complex(*complex_batched_matmul_plain(
        tuple(t.double() for t in sa), tuple(t.double() for t in sb)))
    return [torch.abs(torch.complex(yr[cut].double(), yi[cut].double())
                      - ref).max().item() for yr, yi in ys]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "cmm_route.jsonl"))
    ap.add_argument("--seeds", type=int, default=3)
    args = ap.parse_args()

    import torch

    import chip_smoke
    from artensor_tpu_torch import kernels
    from artensor_tpu_torch.ops import field, pallas_mm
    from tnbench import manifest

    shapes = {}
    for w in manifest.load()["workloads"]:
        width, prods = census(w["name"])
        for step, *shape in prods:
            shapes.setdefault(tuple(shape), []).append(
                f"{w['name']}:{step}")
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.load()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as out:
        head = dict(card=chip_smoke.card_line(), torch=torch.__version__,
                    shapes=len(shapes))
        out.write(json.dumps(head) + "\n")
        print(json.dumps(head), flush=True)
        for (B, M, K, N), where in sorted(
                shapes.items(), key=lambda kv: -kv[0][0] * kv[0][1]
                * (kv[0][2] + kv[0][3])):
            row = dict(B=B, M=M, K=K, N=N, where=where,
                       tile=pallas_mm.cmm_tile(B, M, K, N),
                       routed=pallas_mm.cmm_route(B, M, K, N, "cuda",
                                                  "highest", "naive", "f32"))
            big = B * (M * K + K * N + 2 * M * N) > 1 << 28
            runs = B <= pallas_mm.MAX_BATCH
            errs = []
            for seed in range(args.seeds):
                a, b = operands(B, M, K, N, seed * 7919 + M + K + N)
                cublas = lambda: field._split_dot(a, b, DN)  # noqa: E731
                kern = lambda: pallas_mm.complex_batched_matmul(  # noqa
                    a, b)
                if seed == 0:
                    row["cublas_ms"] = chip_smoke.time_ms(cublas,
                                                          5 if big else 20)
                    if runs:
                        row["cmm_ms"] = chip_smoke.time_ms(kern,
                                                           5 if big else 20)
                if not runs:
                    break
                errs.append(f64_errors(a, b, (kern(), cublas()), B, M, N))
                del a, b
                torch.cuda.empty_cache()
            if errs:
                row["f64_ratio"] = max(e[0] for e in errs) / max(
                    e[1] for e in errs)
                row["f64_ratio_seed_max"] = max(e[0] / e[1] for e in errs)
            out.write(json.dumps(row) + "\n")
            out.flush()
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    t0 = time.perf_counter()
    main()
    print(json.dumps(dict(done=True, seconds=time.perf_counter() - t0)))
