"""Four-step (Cooley-Tukey block) NTT for large transforms.

Counterpart of the JAX package's `ops/ntt_fourstep.py`; `ops/ntt.py` routes
every transform of n >= 2^14 here, on both devices.  An order-n transform
splits into n = n1 * n2 and runs as two passes of short Stockham NTTs along
axis -2, with the other factor riding the last axis as a batch:

Data flow (j = j2*n1 + j1, k = k1*n2 + k2):

  1. view [n] as [n2 (j2), n1 (j1)]                        (free)
  2. NTT along axis -2: j2 -> k2, root of order n2         (pass 1)
  3. elementwise twiddle by w^(j1*k2), table built on the device in
     log2(n1) doubling rounds (~n products)
  4. transpose [k2, j1] -> [j1, k2]                        (the ONE copy)
  5. NTT along axis -2: j1 -> k1, root of order n1         (pass 2)
  6. view [k1, k2] as [n]: already k1*n2 + k2 == k         (free)

Every Stockham stage is one `dif_butterfly` call (the K2 kernel on CUDA
tensors); the twiddle product and the inverse scalings are `fr.mul` (K1).
A stage's twiddle is one value per row of the transformed axis, broadcast
over the batch and the last axis; K2 takes full-width operands, so each
stage materializes that broadcast.

The inverse transform reuses the structure with inverse roots; the two
passes' own 1/n2 and 1/n1 scalings compose to the required 1/n.  Outputs
are exact DFT integers mod p, identical to the Stockham path.
"""

from __future__ import annotations

import torch

from ..fields import FR_MOD
from .limbs import fr, NLIMBS
from .cuda_mont import dif_butterfly
from .ntt import _root_host, _roots_impl, scalar_powers


def _split(n: int):
    """n = n1 * n2 with n1 <= n2, both powers of two."""
    bits = n.bit_length() - 1
    l1 = bits // 2
    return 1 << l1, 1 << (bits - l1)


def _stockham_axis2(a, L: int, inverse: bool):
    """Constant-geometry Stockham DIF along axis -2 (length L).

    a: int32[16, *pre, L, lanes]; every stage is a reshape plus one
    butterfly call — the last axis is never permuted."""
    tw_all = _roots_impl(L, inverse, a.device)  # [16, L] twiddle powers
    nb = a.ndim - 3
    lanes = a.shape[-1]
    shape = a.shape
    l, m = L // 2, 1
    for _ in range(L.bit_length() - 1):
        x = a.reshape(shape[:-2] + (2, l, m, lanes))
        tw = tw_all[:, : l * m : m].reshape((NLIMBS,) + (1,) * nb + (l, 1, 1))
        s, d = dif_butterfly(x[..., 0, :, :, :], x[..., 1, :, :, :], tw)
        a = torch.stack([s, d], dim=-3).reshape(shape)  # [..., l, 2, m, lanes]
        l //= 2
        m *= 2
    if inverse:
        ninv = fr.scalar(pow(L, -1, FR_MOD), a.device)
        a = fr.mul(a, ninv.reshape((NLIMBS,) + (1,) * (nb + 2)))
    return a


def _twiddle_table(n: int, n1: int, n2: int, inverse: bool, device):
    """[16, n2 (k2), n1 (j1)] table of w^(+-j1*k2), w the order-n root.

    Doubling construction along the j1 axis: column 1 holds the order-n
    root powers w^k2 and column (a+b) = column a * column b — log2(n1)
    rounds of Montgomery products, ~n in all, nothing host-side but the
    root."""
    base = scalar_powers(fr.scalar(_root_host(n, inverse), device), n2)  # w^k2
    pw = fr.const("ONE_MONT", device, 3).expand(NLIMBS, n2, 1)
    length = 1
    while length < n1:
        top = fr.mul(pw[:, :, length - 1], base)  # base^length [16, n2]
        ext = fr.mul(pw, top[:, :, None])
        pw = torch.cat([pw, ext], dim=2)
        length *= 2
    return pw[:, :, :n1]


def ntt_fourstep(values, n: int, inverse: bool):
    """values: int32[16, *batch, n] (Montgomery); exact DFT mod p."""
    n1, n2 = _split(n)
    shape = values.shape
    nb = len(shape) - 2

    a = values.reshape(shape[:-1] + (n2, n1))  # [.., j2, j1]
    a = _stockham_axis2(a, n2, inverse)  # [.., k2, j1]

    tw = _twiddle_table(n, n1, n2, inverse, values.device)
    a = fr.mul(a, tw.reshape((NLIMBS,) + (1,) * nb + (n2, n1)))

    a = a.transpose(-1, -2).contiguous()  # [.., j1, k2] — the one real transpose
    a = _stockham_axis2(a, n1, inverse)  # [.., k1, k2]

    return a.reshape(shape)  # k = k1*n2 + k2
