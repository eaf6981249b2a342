"""What a PLONK proof of a circuit must hold, worked out on plain integers.

`Circuit` compiles the benchmark's circuit lines the way the PLONK
compiler of plonkathon defines them: one gate row a line, with
q_L a + q_R b + q_M a b + q_O c + q_C + PI (+ q_cube a^3) = 0, the wires'
copy cycles encoded as omega^row * column (columns 1, 2, 3), and, with a
lookup table, q_K, the table padded to n by its last entry, and the
PlonKup columns f, h1, h2.  It knows five line forms, the ones the
benchmark's circuits use: `v public`, `o <== l * r`, `o <== l * r + l`,
`o <== l * l * l` (a cube gate) and `v lookup`; anything else raises.

`Checker.check(proof, inputs)` judges one proof with the SRS trapdoor
tau.  With an SRS of powers tau^i G, a commitment to p is p(tau) G, so:

* every commitment of rounds 1 and 2 (a, b, c, z; f, h1, h2, z2) must be
  p(tau) G of the polynomial the reference builds from the inputs;
* the quotient's three pieces must meet t_lo + tau^n t_mid + tau^2n t_hi
  = t(tau) G, t(tau) being the gate, permutation and lookup identities at
  tau over Z_H(tau);
* every opening of round 4 must equal the reference's evaluation at zeta
  or zeta * omega, exactly;
* W_zeta (tau - zeta) must equal R(tau) G plus the batched openings, R's
  quotient part taken from the proof's own t pieces at zeta^n, zeta^2n,
  and W_zeta_omega (tau - zeta omega) its batched openings, exactly.

Challenges come from the transcript over what the proof says, so a value
that is wrong once is counted once, and what follows is still judged
against the challenges the prover drew.  Evaluations are barycentric over
the n-th roots of unity, O(n) integer products each."""

from __future__ import annotations

import re

from . import bn254
from .bn254 import R, batch_inv, dot, inv, lincomb, mul_g, on_curve
from .transcript import Transcript

# The counts `Checker.check` returns, each with its limit (see benchmark/check.py).
LIMITS = {
    "commits_wrong": 0,     # a, b, c, z (and f, h1, h2, z2) not p(tau) G
    "quotient_wrong": 0,    # t_lo + tau^n t_mid + tau^2n t_hi not t(tau) G
    "evals_wrong": 0,       # round 4's openings not the reference's evaluations
    "openings_wrong": 0,    # W_zeta, W_zeta_omega not the reference's
}

EVAL_KEYS = ("a_eval", "b_eval", "c_eval", "s1_eval", "s2_eval", "z_shifted_eval")
LOOKUP_EVAL_ORDER = ("f", "t", "h1", "h2", "t_w", "h1_w", "h2_w", "z2_w")

_NAME = r"[A-Za-z][A-Za-z0-9]*"
_FORMS = (
    ("public", re.compile(rf"^({_NAME}) public$")),
    ("lookup", re.compile(rf"^({_NAME}) lookup$")),
    ("cube", re.compile(rf"^({_NAME}) <== ({_NAME}) \* \2 \* \2$")),
    ("muladd", re.compile(rf"^({_NAME}) <== ({_NAME}) \* ({_NAME}) \+ \2$")),
    ("mul", re.compile(rf"^({_NAME}) <== ({_NAME}) \* ({_NAME})$")),
)


def _parse(line: str):
    for kind, pattern in _FORMS:
        m = pattern.match(line)
        if m:
            return kind, m.groups()
    raise ValueError(f"the reference knows no line form {line!r}")


def _roll(v: list) -> list:
    """Lagrange values of p(omega X): row i takes row i + 1."""
    return v[1:] + v[:1]


class Circuit:
    def __init__(self, lines: list[str], n: int, table: list[int] | None = None):
        if len(lines) > n:
            raise ValueError("more lines than rows")
        self.n = n
        self.omega = bn254.root_of_unity(n)
        self.roots = bn254.powers(self.omega, n)
        self.rows = []  # (kind, L, R, O) names, None for an empty wire
        self.public = []
        zero = [0] * n
        self.q = {k: list(zero) for k in ("L", "R", "M", "O", "C", "cube", "K")}
        for i, line in enumerate(lines):
            kind, names = _parse(line)
            if kind == "public":
                if any(r[0] != "public" for r in self.rows):
                    raise ValueError("public lines come first")
                self.public.append(names[0])
                wires = (names[0], None, None)
                self.q["L"][i] = 1
            elif kind == "lookup":
                wires = (names[0], None, None)
                self.q["K"][i] = 1
            elif kind == "cube":
                wires = (names[1], names[1], names[0])
                self.q["O"][i], self.q["cube"][i] = 1, R - 1
            else:
                o, left, right = names
                wires = (left, right, o)
                self.q["M"][i], self.q["O"][i] = R - 1, 1
                if kind == "muladd":
                    self.q["L"][i] = R - 1
            self.rows.append((kind,) + wires)
        self.custom = any(self.q["cube"])
        self.lookup = any(self.q["K"])
        if self.lookup and table is None:
            raise ValueError("lookup lines need a table")
        self.table = None
        if table is not None:
            t = [v % R for v in table]
            self.table = t + [t[-1]] * (n - len(t))
            self.t_last = t[-1]
        self.sigma = self._sigmas()

    def _sigmas(self):
        """The copy cycles: each variable's cells (row, column), sorted,
        each pointing at the next; empty wires and unused rows form the
        cycle of None."""
        n = self.n
        uses = {None: []}
        for row, (_, *wires) in enumerate(self.rows):
            for col, name in zip((1, 2, 3), wires):
                uses.setdefault(name, []).append((row, col))
        for row in range(len(self.rows), n):
            uses[None] += [(row, 1), (row, 2), (row, 3)]
        s = {1: [0] * n, 2: [0] * n, 3: [0] * n}
        roots = self.roots
        for cells in uses.values():
            cells.sort()
            m = len(cells)
            for j, (row, col) in enumerate(cells):
                nrow, ncol = cells[(j + 1) % m]
                s[ncol][nrow] = roots[row] * col % R
        return s[1], s[2], s[3]

    def execute(self, inputs: dict) -> dict:
        """Every variable's value, line by line from the inputs."""
        val = {k: v % R for k, v in inputs.items()}
        for kind, left, right, out in self.rows:
            if kind == "mul":
                got = val[left] * val[right] % R
            elif kind == "muladd":
                got = (val[left] * val[right] + val[left]) % R
            elif kind == "cube":
                got = pow(val[left], 3, R)
            else:
                continue
            if val.setdefault(out, got) != got:
                raise ValueError(f"inputs contradict the line that sets {out}")
        return val

    def columns(self, inputs: dict):
        """The wire columns a, b, c and PI's Lagrange values."""
        val = self.execute(inputs)
        val[None] = 0
        pad = [0] * (self.n - len(self.rows))
        a = [val[r[1]] for r in self.rows] + pad
        b = [val[r[2]] for r in self.rows] + pad
        c = [val[r[3]] for r in self.rows] + pad
        pi = [(R - val[v]) % R for v in self.public] + [0] * (self.n - len(self.public))
        return a, b, c, pi

    def lookup_columns(self, a: list[int]):
        """PlonKup's f (the looked-up value on lookup rows, t_last
        elsewhere) and the halves h1 = s[:n], h2 = s[n-1:] of s, the table
        with f[0..n-2] merged in at each value's first place."""
        n, t = self.n, self.table
        qk = self.q["K"]
        f = [a[i] if qk[i] else self.t_last for i in range(n)]
        count = {}
        for v in f[: n - 1]:
            count[v] = count.get(v, 0) + 1
        if any(v not in set(t) for v in count):
            raise ValueError("a looked-up value is not in the table")
        s, seen = [], set()
        for v in t:
            s.append(v)
            if v not in seen:
                seen.add(v)
                s += [v] * count.get(v, 0)
        return f, s[:n], s[n - 1:]


def _lagrange_at(circuit: Circuit, x: int) -> list[int]:
    """L_i(x) = (x^n - 1) / n * omega^i / (x - omega^i) for every row i."""
    n = circuit.n
    scale = (pow(x, n, R) - 1) * inv(n) % R
    dens = batch_inv([(x - w) % R for w in circuit.roots])
    return [w * scale % R * d % R for w, d in zip(circuit.roots, dens)]


def _grand_product(num: list[int], den: list[int]) -> list[int]:
    """Z_0 = 1, Z_i = prod_{j<i} num_j / den_j."""
    z, acc = [1], 1
    for x, y in zip(num[:-1], batch_inv(den[:-1])):
        acc = acc * x % R * y % R
        z.append(acc)
    return z


class Checker:
    """Judges proofs of one circuit on the SRS of trapdoor tau."""

    def __init__(self, circuit: Circuit, tau: int):
        self.c = circuit
        self.tau = tau % R
        n = circuit.n
        self.lt = _lagrange_at(circuit, self.tau)
        self.tau_n = pow(self.tau, n, R)
        q = circuit.q
        self.q_tau = {k: dot(v, self.lt) for k, v in q.items()}
        self.s_tau = [dot(s, self.lt) for s in circuit.sigma]
        self.l0_tau = self.lt[0]
        if circuit.lookup:
            self.tbl_tau = dot(circuit.table, self.lt)
            self.tbls_tau = dot(_roll(circuit.table), self.lt)
        self.gl = circuit.roots[n - 1]

    def check(self, proof: dict, inputs: dict) -> dict:
        """Counts of what the proof gets wrong: commits_wrong (rounds 1 and
        2), quotient_wrong (the t pieces at tau), evals_wrong (round 4) and
        openings_wrong (W_zeta, W_zeta_omega)."""
        c, n, tau, lt = self.c, self.c.n, self.tau, self.lt
        lk = c.lookup
        wrong = dict(commits_wrong=0, quotient_wrong=0, evals_wrong=0, openings_wrong=0)
        points = ["a_1", "b_1", "c_1", "z_1", "t_lo_1", "t_mid_1", "t_hi_1", "W_z_1", "W_zw_1"]
        scalars = list(EVAL_KEYS)
        if lk:
            points += ["f_1", "h1_1", "h2_1", "z2_1"]
            scalars += [f"lk_{k}_eval" for k in LOOKUP_EVAL_ORDER]
        bad = [k for k in points if proof.get(k) is None or not on_curve(proof[k])]
        bad += [k for k in scalars if not (isinstance(proof.get(k), int) and 0 <= proof[k] < R)]
        if bad:
            # Nothing after a malformed value can be replayed: all of it counts.
            wrong.update(commits_wrong=8 if lk else 4, quotient_wrong=1,
                         evals_wrong=len(scalars), openings_wrong=2)
            return wrong

        def commit(key, value_at_tau):
            if proof[key] != mul_g(value_at_tau):
                wrong["commits_wrong"] += 1

        a, b, cc, pi = c.columns(inputs)
        at, bt, ct, pit = (dot(v, lt) for v in (a, b, cc, pi))
        for key, v in (("a_1", at), ("b_1", bt), ("c_1", ct)):
            commit(key, v)
        tr = Transcript(b"plonk")
        for key in ("a_1", "b_1", "c_1") + (("f_1", "h1_1", "h2_1") if lk else ()):
            tr.point(key.encode(), proof[key])
        beta, gamma = tr.challenge(b"beta"), tr.challenge(b"gamma")
        if lk:
            delta, eps = tr.challenge(b"delta"), tr.challenge(b"epsilon")
            f, h1, h2 = c.lookup_columns(a)
            ft, h1t, h2t = (dot(v, lt) for v in (f, h1, h2))
            for key, v in (("f_1", ft), ("h1_1", h1t), ("h2_1", h2t)):
                commit(key, v)

        # Round 2: the permutation's grand product (and PlonKup's Z2).
        s1, s2, s3 = c.sigma
        bw = [beta * w % R for w in c.roots]
        num = [(ai + x + gamma) * (bi + 2 * x + gamma) % R * (ci + 3 * x + gamma) % R
               for ai, bi, ci, x in zip(a, b, cc, bw)]
        den = [(ai + beta * x1 + gamma) * (bi + beta * x2 + gamma) % R
               * (ci + beta * x3 + gamma) % R
               for ai, bi, ci, x1, x2, x3 in zip(a, b, cc, s1, s2, s3)]
        z = _grand_product(num, den)
        zt, zwt = dot(z, lt), dot(_roll(z), lt)
        commit("z_1", zt)
        tr.point(b"z_1", proof["z_1"])
        if lk:
            od = (1 + delta) % R
            ed = eps * od % R
            t, ts = c.table, _roll(c.table)
            h1s, h2s = _roll(h1), _roll(h2)
            num = [od * (eps + fi) % R * (ed + ti + delta * tsi) % R
                   for fi, ti, tsi in zip(f, t, ts)]
            den = [(ed + x + delta * xs) % R * (ed + y + delta * ys) % R
                   for x, xs, y, ys in zip(h1, h1s, h2, h2s)]
            num[-1] = den[-1] = 1
            z2 = _grand_product(num, den)
            z2t, z2wt = dot(z2, lt), dot(_roll(z2), lt)
            commit("z2_1", z2t)
            tr.point(b"z2_1", proof["z2_1"])
        alpha = tr.challenge(b"alpha")
        tr.challenge(b"fft_cofactor")

        # Round 3: the quotient's identities at tau.
        qt = self.q_tau
        s1t, s2t, s3t = self.s_tau
        gate = (at * qt["L"] + bt * qt["R"] + at * bt % R * qt["M"] + ct * qt["O"]
                + pit + qt["C"] + qt["cube"] * pow(at, 3, R)) % R
        perm = ((at + beta * tau + gamma) * (bt + 2 * beta * tau + gamma) % R
                * (ct + 3 * beta * tau + gamma) % R * zt
                - (at + beta * s1t + gamma) * (bt + beta * s2t + gamma) % R
                * (ct + beta * s3t + gamma) % R * zwt) % R
        ident = gate + alpha * perm + alpha * alpha % R * (zt - 1) % R * self.l0_tau
        if lk:
            ln_t = lt[n - 1]
            xm = tau - self.gl
            t_a = self.l0_tau * (z2t - 1)
            t_b = xm * (z2t * od % R * (eps + ft) % R * (ed + self.tbl_tau + delta * self.tbls_tau)
                        - z2wt * ((ed + h1t + delta * dot(h1s, lt)) % R)
                        * ((ed + h2t + delta * dot(h2s, lt)) % R)) % R
            t_c = ln_t * (h1t - dot(h2s, lt)) % R
            t_d = ln_t * (z2t - 1) % R
            t_e = (qt["K"] * (at - ft) + (1 - qt["K"]) * (c.t_last - ft)) % R
            ext = (t_a + alpha * (t_b + alpha * (t_c + alpha * (t_d + alpha * t_e)))) % R
            ident += pow(alpha, 3, R) * ext
        t_tau = ident % R * inv(self.tau_n - 1) % R
        pieces = [proof["t_lo_1"], proof["t_mid_1"], proof["t_hi_1"]]
        if lincomb(zip(pieces, (1, self.tau_n, self.tau_n * self.tau_n))) != mul_g(t_tau):
            wrong["quotient_wrong"] += 1
        for key, p in zip(("t_lo_1", "t_mid_1", "t_hi_1"), pieces):
            tr.point(key.encode(), p)
        zeta = tr.challenge(b"zeta")

        # Round 4: the openings at zeta and zeta * omega (rows rolled by one).
        lz = _lagrange_at(c, zeta)
        ev = {
            "a_eval": dot(a, lz), "b_eval": dot(b, lz), "c_eval": dot(cc, lz),
            "s1_eval": dot(s1, lz), "s2_eval": dot(s2, lz),
            "z_shifted_eval": dot(_roll(z), lz),
        }
        if lk:
            lkev = {
                "f": dot(f, lz), "t": dot(t, lz), "h1": dot(h1, lz), "h2": dot(h2, lz),
                "t_w": dot(ts, lz), "h1_w": dot(h1s, lz), "h2_w": dot(h2s, lz),
                "z2_w": dot(_roll(z2), lz),
            }
            ev.update({f"lk_{k}_eval": v for k, v in lkev.items()})
        for key in scalars:
            if proof[key] != ev[key]:
                wrong["evals_wrong"] += 1
            tr.scalar(key.removeprefix("lk_").removesuffix("_eval").encode()
                      if key.startswith("lk_") else key.encode(), proof[key])
        v = tr.challenge(b"v")

        # Round 5: the opening proofs.
        ae, be, ce, s1e, s2e, zwe = (ev[k] for k in EVAL_KEYS)
        zn = pow(zeta, n, R)
        zh = (zn - 1) % R
        l0z = zh * inv(n * (zeta - 1)) % R
        pie = dot(pi, lz)
        r_tau = (qt["M"] * ae % R * be + qt["L"] * ae + qt["R"] * be + qt["O"] * ce + pie
                 + qt["C"] + qt["cube"] * pow(ae, 3, R)) % R
        r_tau += alpha * ((ae + beta * zeta + gamma) * (be + 2 * beta * zeta + gamma) % R
                          * (ce + 3 * beta * zeta + gamma) % R * zt
                          - (ae + beta * s1e + gamma) * (be + beta * s2e + gamma) % R
                          * (ce + gamma + beta * s3t) % R * zwe) % R
        r_tau += alpha * alpha % R * l0z % R * (zt - 1) % R
        opened = [(at, ae), (bt, be), (ct, ce), (s1t, s1e), (s2t, s2e)]
        if lk:
            c_z2, c_h1, c_qk, c_const = self._lookup_scalars(alpha, zeta, delta, eps, ae, lkev)
            r_tau += c_z2 * z2t + c_h1 * h1t + c_qk * qt["K"] + c_const
            opened += [(ft, lkev["f"]), (self.tbl_tau, lkev["t"]),
                       (h1t, lkev["h1"]), (h2t, lkev["h2"])]
        acc, vp = r_tau % R, v
        for at_tau, at_zeta in opened:
            acc += vp * (at_tau - at_zeta)
            vp = vp * v % R
        k = inv(tau - zeta)
        wz = lincomb([(bn254.GENERATOR, acc * k), (pieces[0], -zh * k),
                      (pieces[1], -zh * zn % R * k), (pieces[2], -zh * zn % R * zn % R * k)])
        if proof["W_z_1"] != wz:
            wrong["openings_wrong"] += 1
        acc2 = zt - zwe
        if lk:
            vp = v
            for at_tau, at_zw in ((self.tbl_tau, lkev["t_w"]), (h1t, lkev["h1_w"]),
                                  (h2t, lkev["h2_w"]), (z2t, lkev["z2_w"])):
                acc2 += vp * (at_tau - at_zw)
                vp = vp * v % R
        if proof["W_zw_1"] != mul_g(acc2 * inv(tau - zeta * c.omega)):
            wrong["openings_wrong"] += 1
        return wrong

    def _lookup_scalars(self, alpha, zeta, delta, eps, a_ev, e):
        """PlonKup's linearization at zeta: R gains c_z2 Z2 + c_h1 h1 +
        c_qk q_K + c_const (the lookup identities with every opened
        polynomial replaced by its opening)."""
        n, gl = self.c.n, self.gl
        zh = (pow(zeta, n, R) - 1) % R
        l0 = zh * inv(n * (zeta - 1)) % R
        ln = zh * gl % R * inv(n * (zeta - gl)) % R
        xm = (zeta - gl) % R
        od = (1 + delta) % R
        ed = eps * od % R
        a3 = pow(alpha, 3, R)
        a4, a5, a6, a7 = (a3 * pow(alpha, k, R) % R for k in (1, 2, 3, 4))
        tl = self.c.t_last
        c_z2 = (a3 * l0 + a4 * xm % R * od % R * (eps + e["f"]) % R
                * (ed + e["t"] + delta * e["t_w"]) + a6 * ln) % R
        c_h1 = a5 * ln % R
        c_qk = a7 * ((a_ev - e["f"]) - (tl - e["f"])) % R
        c_const = (-a3 * l0
                   - a4 * xm % R * e["z2_w"] % R * ((ed + e["h1"] + delta * e["h1_w"]) % R)
                   % R * ((ed + e["h2"] + delta * e["h2_w"]) % R)
                   - a5 * ln % R * e["h2_w"] - a6 * ln + a7 * (tl - e["f"])) % R
        return c_z2, c_h1, c_qk, c_const


def checker(lines: list[str], cfg: dict, table: list[int] | None, tau: int) -> Checker:
    """The judge of a configuration's proofs: its circuit at `group_order`
    rows on the SRS of trapdoor tau."""
    return Checker(Circuit(lines, cfg["group_order"], table=table), tau)
