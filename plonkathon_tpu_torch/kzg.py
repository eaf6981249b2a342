"""KZG trusted setup: snarkjs .ptau ingestion, commitments, verification keys.

Parses the Powers-of-Tau ceremony format used by snarkjs "prepare phase 2"
files: the log2 power count lives at byte 60, G1 points start at byte 80 as
32-byte little-endian coordinate pairs scaled by a common factor recovered
from the known generator, and the G2 block is located by scanning for the
scaled G2 generator x-coordinate.

Commitments run on the device MSM engine (ops/curve.py); the SRS window
tables are built on the setup's device at first use.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .fields import Fq, Fq2, Fr, FQ_MOD, FR_MOD
from .ec import G1, G2, B2, is_on_curve, pt_add, pt_mul
from .ops.curve import FixedBaseMSM
from .ops.limbs import resolve_device
from .poly import Polynomial, Basis
from . import verifier as _verifier

_POWERS_BYTE = 60
_G1_START = 80


@dataclass
class Setup:
    powers_of_x: list  # [G, xG, x^2 G, ...] host affine points
    X2: tuple          # [x]_2 in G2
    device: object = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._msm = None

    @property
    def msm_engine(self) -> FixedBaseMSM:
        if self._msm is None:
            self._msm = FixedBaseMSM(self.powers_of_x, device=self.device)
        return self._msm

    @classmethod
    def generate(cls, powers: int, tau: int = 0xDEADBEEF1337, device="cuda") -> "Setup":
        """Synthetic known-tau SRS for tests/benchmarks (NOT a trusted setup).

        Points are computed on the device: the 8-bit digits of tau^i select
        from a host-built table T[w][b] = (b * 2^(8w)) * G, gathered
        window-major ([16, 32, n]), one K8a launch sums the 32 windows of
        every point in the pairwise order of a level-by-level halving
        (windows 2j, 2j + 1 first), and a batched inversion converts to
        affine."""
        from .ops import curve as _curve
        from .ops.cuda_mont import jac_window_sum
        from .ops.limbs import fq as _fq
        from .ops.msm2 import affine_from_jacobian

        device = resolve_device(device)
        tau = tau % FR_MOD
        base = G1
        flat = []
        for _ in range(32):
            row = [G1, base]  # entry 0 is masked out below (Z = 0)
            acc = base
            for _ in range(254):
                acc = pt_add(acc, base)
                row.append(acc)
            flat += row
            for _ in range(8):
                base = pt_add(base, base)
        tx, ty = _curve.points_to_device(flat, device)

        taus = []
        cur = 1
        for _ in range(powers):
            taus.append(cur)
            cur = cur * tau % FR_MOD
        dig = np.frombuffer(
            b"".join(t.to_bytes(32, "little") for t in taus), dtype=np.uint8
        ).reshape(powers, 32).astype(np.int64)
        idx = torch.from_numpy((dig + np.arange(32)[None, :] * 256).T.copy()).to(device)
        gx = tx[:, idx]  # [16, 32, n]: window-major
        gy = ty[:, idx]
        flag = torch.from_numpy((dig != 0).T.copy()).to(device)
        gz = torch.where(flag[None], _fq.full("ONE_MONT", gx), torch.zeros_like(gx))

        ax, ay = affine_from_jacobian(*jac_window_sum((gx, gy, gz)))
        xs = _fq.from_mont_host_many(ax)
        ys = _fq.from_mont_host_many(ay)
        pts = [(Fq(a), Fq(b)) for a, b in zip(xs, ys)]
        if pts[0] != G1:
            raise RuntimeError("synthetic SRS sanity: tau^0 * G must be G")
        return cls(pts, pt_mul(G2, tau), device=device)

    @classmethod
    def from_file(cls, filename: str, device="cuda") -> "Setup":
        device = resolve_device(device)
        with open(filename, "rb") as f:
            contents = f.read()
        powers = 2 ** contents[_POWERS_BYTE]
        coords = [
            int.from_bytes(contents[i : i + 32], "little")
            for i in range(_G1_START, _G1_START + 32 * powers * 2, 32)
        ]
        if max(coords) >= FQ_MOD:
            raise ValueError(f"{filename}: G1 coordinate out of range")
        # All encoded coordinates carry a common Montgomery-style factor;
        # recover it from the known generator (first point).
        factor = Fq(coords[0]) / G1[0]
        inv_factor = factor.inv()
        points = [
            (Fq(coords[2 * i] * inv_factor.n), Fq(coords[2 * i + 1] * inv_factor.n))
            for i in range(powers)
        ]
        # Locate the G2 block by scanning for the scaled G2 generator.
        pos = _G1_START + 32 * powers * 2
        target = (factor * G2[0].coeffs[0]).n
        while pos < len(contents):
            if int.from_bytes(contents[pos : pos + 32], "little") == target:
                break
            pos += 1
        else:
            raise ValueError(
                f"{filename}: G2 generator block not found — truncated or "
                "malformed .ptau file"
            )
        if pos + 32 * 8 > len(contents):
            raise ValueError(f"{filename}: .ptau file ends inside the G2 block")
        enc = contents[pos + 32 * 4 : pos + 32 * 8]
        vals = [
            (Fq(int.from_bytes(enc[i : i + 32], "little")) * inv_factor).n
            for i in range(0, 128, 32)
        ]
        x2 = (Fq2(vals[:2]), Fq2(vals[2:]))
        if not is_on_curve(x2, B2):
            raise ValueError(f"{filename}: [x]_2 is not on the twist")
        return cls(points, x2, device=device)

    # -- commitments ------------------------------------------------------
    def commit(self, poly: Polynomial):
        """KZG commitment [p(x)]_1 of Lagrange values (iNTT'd on the
        device) or monomial coefficients."""
        if poly.basis == Basis.LAGRANGE:
            poly = poly.ifft()
        if len(poly) > len(self.powers_of_x):
            raise ValueError("polynomial exceeds SRS")
        return self.msm_engine.commit_mont(poly.values.to(self.device))

    # -- verification key -------------------------------------------------
    def verification_key(self, pk) -> "_verifier.VerificationKey":
        """Commit to the preprocessed polynomials (vanilla PLONK layout)."""
        if pk.QCUBE is not None or pk.QK is not None:
            raise NotImplementedError(
                "custom-gate and PlonKup verification keys arrive with the "
                "prover extensions (ROADMAP Queue 1, item 9)"
            )
        polys = [pk.QM, pk.QL, pk.QR, pk.QO, pk.QC, pk.S1, pk.S2, pk.S3]
        coeffs = [p.ifft().values.to(self.device) for p in polys]
        qm, ql, qr, qo, qc, s1, s2, s3 = self.msm_engine.commit_batch(coeffs)
        return _verifier.VerificationKey(
            group_order=pk.group_order,
            Qm=qm, Ql=ql, Qr=qr, Qo=qo, Qc=qc, S1=s1, S2=s2, S3=s3,
            X_2=self.X2,
            w=Fr.root_of_unity(pk.group_order),
        )
