"""The port's extension algebra against the JAX package's functions on the
same seeded limbs (CPU; JAX runs eagerly at width 32, as plain jnp).

* `_quotient_impl` with the cube-gate term and the five PlonKup identities;
* the lookup grand product Z2 (the port's `_lookup_z2` against JAX's
  `_lookup_z2_kernel`), the wrap-around row masked to one;
* `_linearization_impl` with the cube term and the PlonKup terms;
* FieldOps' inversions and predicates (fr, fq) against the JAX package's
  (moved here from tests/test_torch_fieldops.py, whose helpers they use).

Inputs are random lazy-domain elements [0, 2p); outputs are compared after
`canon` (multi-op chains: the lazy add/sub and the inversions may leave
other raw limbs for the same value).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plonkathon_tpu import prover as jax_prover
from plonkathon_tpu.ops.limbs import fr as jax_fr
from plonkathon_tpu_torch import prover as port_prover
from plonkathon_tpu_torch.fields import FR_MOD
from plonkathon_tpu_torch.ops.limbs import encode_ints, fr

from test_torch_fieldops import PAIRS, _j, _rand, _raw_equal

torch.set_num_threads(1)  # small tensors: threads only contend with xdist

W = 32
LOOKUP_ROWS = port_prover.LOOKUP_ROWS


class Inputs:
    """Seeded lazy-domain limbs, handed to both packages: [16, W] rows and
    [16] scalars, the same bytes as int32 (port) and uint32 (JAX)."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def _limbs(self, count: int) -> np.ndarray:
        vals = [int.from_bytes(self.rng.bytes(32), "little") % (2 * FR_MOD) for _ in range(count)]
        return encode_ints(vals)

    def row(self):
        a = self._limbs(W)
        return torch.from_numpy(a), jnp.asarray(a.astype(np.uint32))

    def scalar(self):
        a = self._limbs(1)[:, 0]
        return torch.from_numpy(np.ascontiguousarray(a)), jnp.asarray(a.astype(np.uint32))


def _pairs(inputs, names, kind):
    made = {name: getattr(inputs, kind)() for name in names}
    return {k: v[0] for k, v in made.items()}, {k: v[1] for k, v in made.items()}


def _same_values(port_out, jax_out):
    want = np.asarray(jax_fr.canon(jax_out)).astype(np.int64)
    got = fr.canon(port_out).numpy().astype(np.int64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


VANILLA = ("a", "b", "c", "pi", "ql", "qr", "qm", "qo", "qc", "z", "zs", "s1", "s2", "s3", "l0")


def test_quotient_with_cube_and_lookup_terms():
    inp = Inputs(20261017)
    rows_t, rows_j = _pairs(inp, VANILLA + ("xvals", "zh_inv", "qcube") + LOOKUP_ROWS, "row")
    sc_t, sc_j = _pairs(inp, ("beta", "gamma", "alpha", "delta", "epsilon", "tlast", "gl"), "scalar")

    def call(impl, rows, sc):
        lookup = {k: rows[k] for k in LOOKUP_ROWS}
        lookup.update({k: sc[k] for k in ("delta", "epsilon", "tlast", "gl")})
        return impl(
            *[rows[k] for k in VANILLA], rows["xvals"], rows["zh_inv"],
            sc["beta"], sc["gamma"], sc["alpha"], qcube=rows["qcube"], lookup=lookup,
        )

    _same_values(call(port_prover._quotient_impl, rows_t, sc_t),
                 call(jax_prover._quotient_impl, rows_j, sc_j))


def test_lookup_grand_product_z2():
    inp = Inputs(20261018)
    rows_t, rows_j = _pairs(inp, ("f", "t", "h1", "h2"), "row")
    sc_t, sc_j = _pairs(inp, ("delta", "epsilon"), "scalar")
    args = ("f", "t", "h1", "h2")
    z2, z2_last = port_prover._lookup_z2(*[rows_t[k] for k in args], sc_t["delta"], sc_t["epsilon"])
    jz2, jz2_last, _ = jax_prover._lookup_z2_kernel(
        *[rows_j[k] for k in args], sc_j["delta"], sc_j["epsilon"], n=W
    )
    _same_values(z2, jz2)
    _same_values(z2_last, jz2_last)
    # Z2[0] = 1, and the masked last row leaves the closing value equal to
    # the last prefix product.
    assert fr.from_mont_host(z2[:, 0]) == 1


@pytest.mark.parametrize("lookup", [False, True], ids=["cube", "cube+lookup"])
def test_linearization_with_cube_and_lookup_terms(lookup):
    inp = Inputs(20261019)
    rows_t, rows_j = _pairs(
        inp, VANILLA + ("t1", "t2", "t3", "xvals", "qcube", "f", "t", "h1", "h2", "z2", "qk"), "row"
    )
    names = (
        "a_ev", "b_ev", "c_ev", "s1_ev", "s2_ev", "zw_ev", "pi_ev", "l0_ev", "zh_ev",
        "zeta_n", "zeta_2n", "beta", "gamma", "alpha", "zeta", "zeta_w", "v", "cube_ev",
        "c_z2", "c_h1", "c_qk", "c_const", "f_ev", "t_ev", "h1_ev", "h2_ev", "t_w_ev",
        "h1_w_ev", "h2_w_ev", "z2_w_ev",
    )
    sc_t, sc_j = _pairs(inp, names, "scalar")

    def call(impl, rows, sc):
        lk = None
        if lookup:
            lk = {k: rows[k] for k in ("f", "t", "h1", "h2", "z2", "qk")}
            lk.update({k: sc[k] for k in names[18:]})
        return impl(
            [rows[k] for k in VANILLA], rows["t1"], rows["t2"], rows["t3"], rows["xvals"],
            *[sc[k] for k in names[:17]],
            qcube=rows["qcube"], cube_ev=sc["cube_ev"], lookup=lk,
        )

    for got, want in zip(call(port_prover._linearization_impl, rows_t, sc_t),
                         call(jax_prover._linearization_impl, rows_j, sc_j)):
        _same_values(got, want)


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_fieldops_inversions_and_predicates(field):
    ours, theirs = PAIRS[field]
    rng = np.random.default_rng(102)
    a = _rand(rng, ours, 16)[:, 3:]  # nonzero lanes
    # Fermat inversion: the same square-and-multiply, the same raw limbs.
    assert _raw_equal(ours.inv(a), theirs.inv(_j(a)))
    # The product tree inverts on the host at its root: same values mod p.
    inv = ours.batch_inv(a)
    p = ours.modulus
    for x, y in zip(ours.from_mont_host_many(a), ours.from_mont_host_many(inv)):
        assert x * y % p == 1
    assert _raw_equal(ours.pow_int(a, 11), theirs.pow_int(_j(a), 11))
    z = torch.cat([a[:, :2], ours.const("P", "cpu", 2), torch.zeros_like(a[:, :1])], dim=1)
    assert ours.is_zero(z).tolist() == [False, False, True, True]
    assert ours.eq(z, ours.canon(z)).all()
