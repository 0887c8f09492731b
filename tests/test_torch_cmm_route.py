"""The dot fallback's route to the complex matmul kernel, on the CPU.

``ops/pallas_mm.cmm_route`` decides, from the product's shape, device,
precision, algorithm and storage alone, which split products run as one
launch of the kernel (``csrc/pair.cu`` ``cmm_launch``) and which stay on
four cuBLAS products (``ops/field._split_dot``); ``cmm_tile`` picks the
kernel's tile from the shape.  Held here: the rule at the benchmark
cells' product shapes, that nothing is routed on the CPU or in the modes
that keep cuBLAS, that the routed product's reshapes give the split
product's values, and the device peak model's operand copies.  The
kernel's speed and accuracy at these shapes are held on the card
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from artensor_tpu_torch.ops import field, pallas_mm
from artensor_tpu_torch.ops.einsum import PRECISIONS
from artensor_tpu_torch.ops.field import FusedField, SplitField, make_field
from artensor_tpu_torch.runtime import metrics, tracing
from artensor_tpu_torch.runtime.lowering import lower_step

# (B, M, K, N) of dot products on the benchmark cells' paths at their
# widths, and whether the kernel takes them
CELL_PRODUCTS = {
    "dense_k256": ((1, 65536, 256, 16384), True),
    "dense_k128": ((1, 1 << 23, 128, 128), True),
    "dense_k64": ((1, 1 << 24, 64, 64), True),
    "dense_k32": ((1, 1 << 25, 32, 32), True),
    "dense_k16": ((1, 1 << 26, 16, 16), True),
    "sc25_swap_m64": ((1, 64, 64, 1 << 24), True),
    "sc25_swap_m32": ((1, 32, 32, 1 << 25), True),
    "sc25_chunk_n2": ((123, 65536, 32, 2), True),
    "10k_k16": ((1, 262144, 16, 64), True),
    "1k_k8_n128": ((1, 65536, 8, 128), True),
    # K below 16: on the three-term split
    "dense_k8": ((1, 1 << 27, 8, 8), True),
    "1k_k8_chunk": ((31616, 1024, 8, 8), True),
    # K below 8: float32 accuracy not kept
    "1k_k2": ((1, 65536, 2, 8), False),
    "tiny_k1": ((1, 4, 1, 4), False),
    "sc25_k1": ((1, 262144, 1, 16), False),
    # a 4x padded M tile at K 128: no faster than cuBLAS
    "sc25_b32000": ((32000, 32, 128, 32), False),
    # launch-bound: a few us to gain
    "sc25_rows_n1": ((1000, 32, 32, 1), False),
    "1k_tiny_k8": ((1, 32, 8, 32), False),
    "10k_k8": ((1, 32768, 8, 64), False),
    # a batch past the kernel's slice width
    "10k_b1280000": ((1280000, 1, 16, 1), False),
}


@pytest.mark.parametrize("name", sorted(CELL_PRODUCTS))
def test_route_at_the_cells_products(name):
    """At the cells' dot products the rule sends to the kernel the
    shapes at which it was measured faster and within float32 accuracy
    on the card (PERF.md), and keeps the rest on cuBLAS."""
    shape, routed = CELL_PRODUCTS[name]
    assert pallas_mm.cmm_route(*shape, "cuda", "highest", "naive",
                               "f32") is routed


@pytest.mark.parametrize("device,precision,algo,storage", [
    ("cpu", "highest", "naive", "f32"),
    ("cuda", "default", "naive", "f32"),
    ("cuda", "highest", "karatsuba", "f32"),
    ("cuda", "highest", "naive", "bf16"),
    ("cuda", "highest", "naive", "f16"),
    (torch.device("cpu"), PRECISIONS["high"], "naive", "f32")])
def test_route_keeps_cublas_off_the_card_and_outside_3xtf32(
        device, precision, algo, storage):
    """No shape is routed on the CPU, at one TF32 pass ('default'), for
    karatsuba or for reduced storage."""
    for shape, _ in CELL_PRODUCTS.values():
        assert not pallas_mm.cmm_route(*shape, device, precision, algo,
                                       storage)


def test_route_is_a_function_of_its_arguments():
    """'high' and 'highest' alike, by name or as ``Precision``; a device
    by type or as ``torch.device`` (any card index): the same answer."""
    shape = CELL_PRODUCTS["dense_k64"][0]
    got = {pallas_mm.cmm_route(*shape, dev, prec, "naive", "f32")
           for dev in ("cuda", "cuda:1", torch.device("cuda", 0))
           for prec in ("high", "highest", PRECISIONS["highest"])}
    assert got == {True}


@pytest.mark.parametrize("shape,tile", [
    ((1, 1 << 27, 8, 8), (16, 16, False, 6)),
    ((1, 1 << 26, 16, 16), (16, 16, False, 3)),
    ((1, 1 << 25, 32, 32), (32, 32, False, 3)),
    ((1, 65536, 256, 16384), (64, 32, False, 3)),
    ((1, 64, 64, 1 << 24), (64, 32, True, 3)),
    ((1, 32, 32, 1 << 25), (32, 32, True, 3)),
    ((123, 65536, 32, 2), (16, 32, False, 3)),
    ((32, 1024, 256, 1024), (64, 32, False, 3)),
    ((32000, 32, 128, 32), (32, 32, False, 3)),
    ((1, 4, 4, 1024), (16, 16, True, 6))])
def test_tile_from_the_products_shape(shape, tile):
    """``cmm_tile``: the N tile the narrowest that holds N (after the
    swap), the 16-deep K chunk for K <= 16, the swap where M is below the
    128-row tile and N is not, the three-term split (six products) below
    K 16."""
    assert pallas_mm.cmm_tile(*shape) == tile


DNUMS = [  # (shape a, shape b, dnums): one batch dim, permuted operands,
           # a width folded into a free dim, a vector
    ((3, 4, 5), (5, 6), (((2,), (0,)), ((), ()))),
    ((2, 3, 4, 5), (2, 5, 4, 7), (((3, 2), (1, 2)), ((0,), (0,)))),
    ((4, 2, 3), (3, 4, 6), (((2,), (0,)), ((0,), (1,)))),
    ((5, 2, 8), (8, 2, 3), (((2,), (0,)), ((1,), (1,)))),
    ((6, 5), (5,), (((1,), (0,)), ((), ()))),
]


@pytest.mark.parametrize("case", range(len(DNUMS)))
def test_routed_product_reshapes_give_the_split_product(case):
    """``_cmm_dot`` (both components in matrix form at once, row-major
    for the kernel, the product's output axes), run here through the
    kernel wrapper's plain version, equals ``_split_dot``'s product;
    ``product_dims`` is the matrix product it forms."""
    sa, sb, dn = DNUMS[case]
    gen = torch.Generator().manual_seed(case)
    a = tuple(torch.randn(sa, generator=gen) for _ in "ri")
    b = tuple(torch.randn(sb, generator=gen) for _ in "ri")
    got = field._cmm_dot(a, b, dn)
    want = field._split_dot(a, b, dn)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
    B, M, K, N = field.product_dims(sa, sb, dn)
    assert B * M * N == want[0].numel()
    assert B * M * K == int(np.prod(sa)) and B * K * N == int(np.prod(sb))


def test_row_major_copies_only_what_the_kernel_cannot_read():
    """A row-major pair (or one matrix read by every batch entry, batch
    stride 0) is passed as it is; a transposed view is copied, both
    components together."""
    x = tuple(torch.randn(2, 3, 4) for _ in "ri")
    assert all(o is c for o, c in zip(field._row_major(x), x))
    one = tuple(torch.randn(1, 3, 4).expand(5, 3, 4) for _ in "ri")
    assert all(o is c for o, c in zip(field._row_major(one), one))
    t = tuple(c.transpose(1, 2) for c in x)
    out = field._row_major(t)
    assert all(o.is_contiguous() and torch.equal(o, c)
               for o, c in zip(out, t))


@pytest.mark.parametrize("mode,algo", [("split", "naive"),
                                       ("split", "karatsuba"),
                                       ("fused", "naive")])
def test_cpu_dot_sends_nothing_to_the_kernel(monkeypatch, mode, algo):
    """On the CPU every split product is ``_split_dot``'s, bit for bit:
    the route is not asked, the routed path not taken, and no ``dot.*``
    product counted (those count products made on the card)."""
    asked = []
    monkeypatch.setattr(pallas_mm, "cmm_route",
                        lambda *a: asked.append(a) or True)
    monkeypatch.setattr(field, "_cmm_dot", lambda *a: pytest.fail(
        "routed on the CPU"))
    before = {k: v for k, v in tracing.counters().items()
              if k.startswith("dot.")}
    f = make_field(np.complex64, "highest", mode, algo)
    helper = f if mode == "split" else SplitField(algo=algo, cmm=False)
    for sa, sb, dn in DNUMS:
        gen = torch.Generator().manual_seed(len(sa))
        a = tuple(torch.randn(sa, generator=gen) for _ in "ri")
        b = tuple(torch.randn(sb, generator=gen) for _ in "ri")
        got = helper.dot(a, b, dn)
        want = field._split_dot(a, b, dn, algo)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert asked == []
    assert {k: v for k, v in tracing.counters().items()
            if k.startswith("dot.")} == before


def test_only_the_split_float32_field_may_route():
    """The fused field's split steps, reduced storage and complex128 keep
    cuBLAS whatever the route says (``SplitField.cmm``)."""
    assert SplitField().cmm
    assert not SplitField(cmm=False).cmm
    assert not SplitField(storage="bf16").cmm
    assert not SplitField(np.complex128).cmm
    assert not FusedField().__dict__.get("cmm", False)


def _low(dims_i, dims_j):
    """A lowered step contracting ``c`` of (a, c) and (c, b) operands
    whose matrix forms need a permute of the first (c before a)."""
    return lower_step(("c", "a"), ("c", "b"), ("a", "b"), dims_i, dims_j)


def test_dot_copy_elems_holds_both_components_of_a_routed_product(
        monkeypatch):
    """The device peak model's operand copies: a product on the kernel
    holds both components of each permuted operand (their split-pair
    elements whole), one on cuBLAS the larger operand's one component at
    a time (half)."""
    low = _low((64, 1 << 20), (64, 64))
    big = max(int(np.prod(low.shape_l)), int(np.prod(low.shape_r)))
    assert max(metrics.dot_copy_elems(low)) == big
    monkeypatch.setattr(pallas_mm, "cmm_route", lambda *a: False)
    assert max(metrics.dot_copy_elems(low)) == 0.5 * big


@pytest.mark.parametrize("made,launches,ran,ok", [
    (28, 14, 28, True),      # 14 a group: warm-up 14 + a replay's 14
    (30, 16, 44, True),      # 14 a group, the dense walk's 2 run once
    (28, 14, 27, False),     # a replay's launch missing on the card
    (29, 14, 28, False)])    # the capture recorded 15 (not a group's 14)
def test_chip_smoke_holds_cmm_runs_to_the_routed_products(made, launches,
                                                          ran, ok):
    """``chip_smoke.cmm_held``: a capture records a group's routed dot
    products without launching them (``dot.cmm`` made less launched, over
    the captures, is a group's); the warm-up groups launch as many each
    and the card runs those launches and every replay's group."""
    import chip_smoke

    st = dict(captures=1, warmup_groups=1, replays=1 if ran < 40 else 2)
    cmm = dict(made=made, launches=launches, runs={"cmm": ran})
    once = launches > made - launches
    if not ok:
        with pytest.raises(chip_smoke.SmokeFailure):
            chip_smoke.cmm_held("p", cmm, st, once=once)
        return
    got = chip_smoke.cmm_held("p", cmm, st, once=once)
    assert got["per_group"] == 14 and got["device_launches"] == ran
