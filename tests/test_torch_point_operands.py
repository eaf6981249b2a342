"""How the point kernels' wrappers hand their operands over (CPU).

K8a add and K8b take one pointer per coordinate with a limb stride and a
column stride (`cuda_mont.point_operand`), so the views a caller passes
reach the card without a copy; K7 takes rows of one stacked [48, n], which
`cuda_mont.stack_points` finds in its caller's coordinates.  On the CPU the
wrappers take the plain versions, which must give the same result for every
layout of the same values."""

import numpy as np
import pytest
import torch

from plonkathon_tpu_torch.ops import cuda_mont as CM

from test_torch_kernels_cuda import coords, point_pairs

torch.set_num_threads(1)  # small tensors: threads only contend with xdist

W = 24


def _layouts(rng):
    """(name, coordinate [16, W] as the kernel sees it after broadcasting,
    whether the wrapper hands it over without a copy)."""
    a, _ = point_pairs(rng, W)
    wide, _ = point_pairs(rng, 2 * W)
    col = coords(a)[0][:, 3:4]
    partial = coords(a)[1][:, :4].reshape(16, 1, 4)
    return [
        ("row block of a stacked [48, W]", coords(a)[1], True),
        ("first W columns of a [16, 2W]", coords(wide)[0][:, :W], True),
        ("a column of a [16, W], broadcast", col.expand(16, W), True),
        ("a [16, 1] of its own, broadcast", col.contiguous().expand(16, W), True),
        ("every other column", coords(wide)[2][:, ::2], False),
        ("[16, 1, 4] broadcast to [16, 6, 4]", partial.expand(16, 6, 4), False),
    ]


def test_point_operand_addresses_every_element():
    for name, x, zero_copy in _layouts(np.random.default_rng(30)):
        v, limb, col = CM.point_operand(x, W)
        seen = torch.as_strided(v, (16, W), (limb, col))
        assert torch.equal(seen, x.reshape(16, W)), name
        assert (v.data_ptr() == x.data_ptr()) == zero_copy, name
        assert col in (0, 1), name


@pytest.mark.parametrize("op", ["jac_add", "jac_madd"])
def test_point_wrappers_cpu_route_on_views(op):
    """Broadcast and non-contiguous operands give the result of the same
    values laid out contiguously (lanes 0-4: identity + P, P + identity,
    P + P, -P + P, P + Q; q broadcast from lane 2 of b, which is P)."""
    rng = np.random.default_rng(31)
    a, b = point_pairs(rng, W)
    wide = torch.cat([a, torch.zeros_like(a)], dim=1)  # a in the first W columns
    strided = torch.stack([a, b], dim=2).reshape(48, 2 * W)[:, ::2]  # a again
    nq = 3 if op == "jac_add" else 2
    qs = [coords(b)[:nq], tuple(c[:, 2:3] for c in coords(b)[:nq])]
    ps = [coords(a), tuple(c[:, :W] for c in coords(wide)), coords(strided)]
    for q in qs:
        want = getattr(CM, f"{op}_plain")(
            coords(a), tuple(c.expand(16, W).contiguous() for c in q)
        )
        for p in ps:
            got = getattr(CM, op)(p, q)
            assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_stack_points_zero_copy():
    a, b = point_pairs(np.random.default_rng(32), W)
    parent = a.reshape(48, 2, W // 2)
    rows = CM.unstack_points(parent, (2, W // 2))
    got = CM.stack_points(rows, W)
    assert got.data_ptr() == a.data_ptr() and torch.equal(got, a)
    for apart in (
        tuple(c.clone() for c in rows),  # separate tensors
        rows[::-1],  # not in order
        coords(a)[:2] + coords(b)[2:],  # not one tensor
    ):
        got = CM.stack_points(apart, W)
        assert got.data_ptr() != a.data_ptr()
        assert torch.equal(got, torch.cat([c.reshape(16, W) for c in apart]))
