"""The card tests' cases against the schemes, on the CPU: for every path
of ``card_paths.KERNEL_STEPS`` (each cell's default scheme and the off
form, the dense state and its block walk), the slice width and the
kernel steps by kind that ``tests/test_torch_card_paths.py`` is
parametrised by are the ones the compiled scheme runs there
(``sparse.kernel_kind`` over its device steps: the census, and a block
walk's steps run once), and so are the (path, kind) pairs of its
float64 and one-pass checks.  A path whose cases drift from its scheme
fails here before the card runs it."""

import pytest

import card_paths as cp


@pytest.mark.parametrize("label", list(cp.KERNEL_STEPS))
def test_card_cases_are_the_schemes_kernel_steps(label):
    path = cp.compile_label(label)
    assert cp.step_cases(path) == cp.KERNEL_STEPS[label]
    census = {k: n + path.get("census_once", {}).get(k, 0)
              for k, n in path["census"].items() if k != "dot"}
    census.update({k: n for k, n in path.get("census_once", {}).items()
                   if k != "dot" and k not in census})
    assert census == cp.KERNEL_STEPS[label][1]
    assert {k for k in path["cases"] if cp.f64_case(path, k)} == \
        {k for lb, k in cp.F64_CASES if lb == label}
    assert {k for k in cp.ONE_PASS_KINDS if cp.mma_steps(path, k)} == \
        {k for lb, k in cp.ONE_PASS_CASES if lb == label}


def test_card_cases_cover_every_kernel():
    """Some path plans a step of every kernel kind, so every kernel is
    held to its plain version at a path's step; and every (path, kind)
    of the float64 and one-pass checks names a path and a kind it runs."""
    kinds = {k for _, (_, ks) in cp.KERNEL_STEPS.items() for k in ks}
    assert kinds == set(cp.KERNELS)
    for label, kind in cp.F64_CASES + cp.ONE_PASS_CASES:
        assert kind in cp.KERNEL_STEPS[label][1]
