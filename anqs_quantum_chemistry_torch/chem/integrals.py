"""Molecular integrals over contracted Cartesian Gaussians (McMurchie-Davidson).

Standalone numpy/scipy replacement for the PySCF integral path the reference
uses (reference: nqs/nqs/applications/quantum_chemistry/run_pyscf.py:159-192).
Computes overlap S, kinetic T, nuclear attraction V and two-electron repulsion
integrals (chemist notation (pq|rs)) for s/p shells via Hermite-Gaussian
expansions and the Boys function.

Intended for molecule preparation only (host-side, disk-cached) -- not a hot
path. 8-fold permutational symmetry is exploited for the ERIs.

The port's own copy of the JAX package's ``chem/integrals.py`` (numpy and scipy only,
unchanged in its arithmetic), so that the port builds molecules without
importing the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
from scipy.special import hyp1f1

from .basis import ELEMENTS, Shell


def boys(n_max: int, x: float) -> np.ndarray:
    """Boys functions F_0(x)..F_n_max(x)."""
    ns = np.arange(n_max + 1)
    return hyp1f1(ns + 0.5, ns + 1.5, -x) / (2 * ns + 1)


def hermite_coefs(i: int, j: int, a: float, b: float, q: float) -> np.ndarray:
    """Hermite expansion coefficients E_t^{ij} for t = 0..i+j.

    ``q = Ax - Bx`` is the 1D center separation; a, b the exponents.
    """
    p = a + b
    mu = a * b / p
    table: Dict[Tuple[int, int], np.ndarray] = {}
    e00 = np.zeros(1)
    e00[0] = math.exp(-mu * q * q)
    table[(0, 0)] = e00

    def get(ii, jj):
        if (ii, jj) in table:
            return table[(ii, jj)]
        out = np.zeros(ii + jj + 1)
        if ii > 0:
            prev = get(ii - 1, jj)
            shift = (b / p) * q  # Px - Ax = -b/p * (Ax - Bx) ... sign below
            for t in range(ii + jj + 1):
                val = 0.0
                if t - 1 >= 0 and t - 1 < len(prev):
                    val += prev[t - 1] / (2 * p)
                if t < len(prev):
                    val += (-b / p) * q * prev[t]
                if t + 1 < len(prev):
                    val += (t + 1) * prev[t + 1]
                out[t] = val
        else:
            prev = get(ii, jj - 1)
            for t in range(ii + jj + 1):
                val = 0.0
                if t - 1 >= 0 and t - 1 < len(prev):
                    val += prev[t - 1] / (2 * p)
                if t < len(prev):
                    val += (a / p) * q * prev[t]
                if t + 1 < len(prev):
                    val += (t + 1) * prev[t + 1]
                out[t] = val
        table[(ii, jj)] = out
        return out

    return get(i, j)


def hermite_coulomb(t_max: int, u_max: int, v_max: int, p: float,
                    pc: np.ndarray) -> np.ndarray:
    """Hermite Coulomb integrals R_{tuv} (order 0), full (t,u,v) table."""
    n_tot = t_max + u_max + v_max
    x2 = p * float(pc @ pc)
    f = boys(n_tot, x2)
    # R^n_{000} = (-2p)^n F_n
    rn = {(0, 0, 0, n): ((-2.0 * p) ** n) * f[n] for n in range(n_tot + 1)}

    def get(t, u, v, n):
        key = (t, u, v, n)
        if key in rn:
            return rn[key]
        if t > 0:
            val = 0.0
            if t > 1:
                val += (t - 1) * get(t - 2, u, v, n + 1)
            val += pc[0] * get(t - 1, u, v, n + 1)
        elif u > 0:
            val = 0.0
            if u > 1:
                val += (u - 1) * get(t, u - 2, v, n + 1)
            val += pc[1] * get(t, u - 1, v, n + 1)
        else:
            val = 0.0
            if v > 1:
                val += (v - 1) * get(t, u, v - 2, n + 1)
            val += pc[2] * get(t, u, v - 1, n + 1)
        rn[key] = val
        return val

    out = np.zeros((t_max + 1, u_max + 1, v_max + 1))
    for t in range(t_max + 1):
        for u in range(u_max + 1):
            for v in range(v_max + 1):
                out[t, u, v] = get(t, u, v, 0)
    return out


def primitive_norm(l: Tuple[int, int, int], a: float) -> float:
    i, j, k = l
    df = lambda m: math.prod(range(2 * m - 1, 0, -2)) if m > 0 else 1
    return (
        (2 * a / math.pi) ** 0.75
        * (4 * a) ** ((i + j + k) / 2)
        / math.sqrt(df(i) * df(j) * df(k))
    )


class _BasisData:
    """Normalized, flattened primitive data for a shell list."""

    def __init__(self, shells: Sequence[Shell]):
        self.shells = list(shells)
        self.n_ao = sum(s.n_functions for s in shells)
        self.ao_offsets = np.cumsum(
            [0] + [s.n_functions for s in shells]
        )[:-1]
        # Per shell: normalized contraction coefficients per primitive for the
        # first Cartesian component (all components share the norm for l<=1).
        self.norm_coefs: List[np.ndarray] = []
        for s in shells:
            powers = s.cartesian_powers()[0]
            c = np.array(
                [
                    coef * primitive_norm(powers, a)
                    for a, coef in zip(s.exps, s.coefs)
                ]
            )
            # Contracted self-overlap for normalization.
            self_ov = 0.0
            for ai, ci in zip(s.exps, c):
                for aj, cj in zip(s.exps, c):
                    self_ov += ci * cj * _prim_overlap_same_center(
                        powers, ai, aj
                    )
            self.norm_coefs.append(c / math.sqrt(self_ov))


def _prim_overlap_same_center(powers, a, b):
    i, j, k = powers
    p = a + b
    df = lambda m: math.prod(range(2 * m - 1, 0, -2)) if m > 0 else 1

    def dim(m):
        return df(m) / (2 * p) ** m

    return (math.pi / p) ** 1.5 * dim(i) * dim(j) * dim(k)


def _shell_pair_1e(sh_a: Shell, ca, sh_b: Shell, cb, atoms):
    """(S, T, V) blocks for one shell pair; each (na, nb)."""
    ra = np.asarray(sh_a.center)
    rb = np.asarray(sh_b.center)
    pows_a = sh_a.cartesian_powers()
    pows_b = sh_b.cartesian_powers()
    na, nb = len(pows_a), len(pows_b)
    s_blk = np.zeros((na, nb))
    t_blk = np.zeros((na, nb))
    v_blk = np.zeros((na, nb))

    for a, wa in zip(sh_a.exps, ca):
        for b, wb in zip(sh_b.exps, cb):
            p = a + b
            big_p = (a * ra + b * rb) / p
            w = wa * wb
            pref = (math.pi / p) ** 1.5
            # Per-dimension E tables up to j+2 for kinetic.
            e_cache = {}

            def e_tab(i, j, d):
                key = (i, j, d)
                if key not in e_cache:
                    e_cache[key] = hermite_coefs(
                        i, j, a, b, ra[d] - rb[d]
                    )
                return e_cache[key]

            for ia, pa in enumerate(pows_a):
                for ib, pb in enumerate(pows_b):
                    s_d = [e_tab(pa[d], pb[d], d)[0] for d in range(3)]
                    s_blk[ia, ib] += w * pref * s_d[0] * s_d[1] * s_d[2]

                    # Kinetic: sum over dimensions of 1D kinetic x other
                    # overlaps.
                    t_tot = 0.0
                    for d in range(3):
                        j = pb[d]
                        tk = b * (2 * j + 1) * e_tab(pa[d], j, d)[0]
                        tk -= 2 * b * b * e_tab(pa[d], j + 2, d)[0]
                        if j >= 2:
                            tk -= 0.5 * j * (j - 1) * e_tab(pa[d], j - 2, d)[0]
                        others = math.prod(
                            s_d[dd] for dd in range(3) if dd != d
                        )
                        t_tot += tk * others
                    t_blk[ia, ib] += w * pref * t_tot

                    # Nuclear attraction.
                    lmax = [pa[d] + pb[d] for d in range(3)]
                    e_full = [e_tab(pa[d], pb[d], d) for d in range(3)]
                    v_tot = 0.0
                    for element, xyz in atoms:
                        z = ELEMENTS[element]
                        pc = big_p - np.asarray(xyz)
                        r_tab = hermite_coulomb(
                            lmax[0], lmax[1], lmax[2], p, pc
                        )
                        acc = 0.0
                        for t in range(lmax[0] + 1):
                            for u in range(lmax[1] + 1):
                                for v in range(lmax[2] + 1):
                                    acc += (
                                        e_full[0][t]
                                        * e_full[1][u]
                                        * e_full[2][v]
                                        * r_tab[t, u, v]
                                    )
                        v_tot -= z * acc
                    v_blk[ia, ib] += w * (2 * math.pi / p) * v_tot

    return s_blk, t_blk, v_blk


def _shell_quartet_eri(sh, cs, idx):
    """ERI block (na,nb,nc,nd) for shells idx=(i,j,k,l), chemist (ij|kl)."""
    i, j, k, l = idx
    sa, sb, sc, sd = sh[i], sh[j], sh[k], sh[l]
    ra, rb = np.asarray(sa.center), np.asarray(sb.center)
    rc, rd = np.asarray(sc.center), np.asarray(sd.center)
    pa_l, pb_l = sa.cartesian_powers(), sb.cartesian_powers()
    pc_l, pd_l = sc.cartesian_powers(), sd.cartesian_powers()
    out = np.zeros((len(pa_l), len(pb_l), len(pc_l), len(pd_l)))

    for a, wa in zip(sa.exps, cs[i]):
        for b, wb in zip(sb.exps, cs[j]):
            p = a + b
            big_p = (a * ra + b * rb) / p
            eab = [
                [
                    hermite_coefs(ii, jj, a, b, ra[d] - rb[d])
                    for d in range(3)
                ]
                for ii, jj in [(1, 1)]
            ]
            # cache E tables lazily per (ia, ib) below instead

            for c, wc in zip(sc.exps, cs[k]):
                for d_, wd in zip(sd.exps, cs[l]):
                    q = c + d_
                    big_q = (c * rc + d_ * rd) / q
                    alpha = p * q / (p + q)
                    w = wa * wb * wc * wd
                    pref = (
                        2 * math.pi**2.5
                        / (p * q * math.sqrt(p + q))
                    )
                    lmax_ab = [
                        max(pa[dd] + pb[dd] for pa in pa_l for pb in pb_l)
                        for dd in range(3)
                    ]
                    lmax_cd = [
                        max(pc[dd] + pd[dd] for pc in pc_l for pd in pd_l)
                        for dd in range(3)
                    ]
                    r_tab = hermite_coulomb(
                        lmax_ab[0] + lmax_cd[0],
                        lmax_ab[1] + lmax_cd[1],
                        lmax_ab[2] + lmax_cd[2],
                        alpha,
                        big_p - big_q,
                    )
                    e_ab = {}
                    e_cd = {}
                    for dd in range(3):
                        for pa in set(x[dd] for x in pa_l):
                            for pb in set(x[dd] for x in pb_l):
                                e_ab[(pa, pb, dd)] = hermite_coefs(
                                    pa, pb, a, b, ra[dd] - rb[dd]
                                )
                        for pc in set(x[dd] for x in pc_l):
                            for pd in set(x[dd] for x in pd_l):
                                e_cd[(pc, pd, dd)] = hermite_coefs(
                                    pc, pd, c, d_, rc[dd] - rd[dd]
                                )

                    for ia, pa in enumerate(pa_l):
                        for ib, pb in enumerate(pb_l):
                            ex = e_ab[(pa[0], pb[0], 0)]
                            ey = e_ab[(pa[1], pb[1], 1)]
                            ez = e_ab[(pa[2], pb[2], 2)]
                            for ic, pc in enumerate(pc_l):
                                for id_, pd in enumerate(pd_l):
                                    fx = e_cd[(pc[0], pd[0], 0)]
                                    fy = e_cd[(pc[1], pd[1], 1)]
                                    fz = e_cd[(pc[2], pd[2], 2)]
                                    acc = 0.0
                                    for t in range(len(ex)):
                                        for u in range(len(ey)):
                                            for v in range(len(ez)):
                                                etuv = (
                                                    ex[t] * ey[u] * ez[v]
                                                )
                                                if etuv == 0.0:
                                                    continue
                                                for tt in range(len(fx)):
                                                    for uu in range(len(fy)):
                                                        for vv in range(
                                                            len(fz)
                                                        ):
                                                            sign = (
                                                                -1.0
                                                            ) ** (
                                                                tt + uu + vv
                                                            )
                                                            acc += (
                                                                etuv
                                                                * fx[tt]
                                                                * fy[uu]
                                                                * fz[vv]
                                                                * sign
                                                                * r_tab[
                                                                    t + tt,
                                                                    u + uu,
                                                                    v + vv,
                                                                ]
                                                            )
                                    out[ia, ib, ic, id_] += w * pref * acc
    return out


def compute_integrals_ao(
    atoms: Sequence[Tuple[str, Tuple[float, float, float]]],
    shells: Sequence[Shell],
):
    """All AO integrals: returns dict with S, T, V, ERI (chemist (pq|rs))."""
    data = _BasisData(shells)
    n = data.n_ao
    s_mat = np.zeros((n, n))
    t_mat = np.zeros((n, n))
    v_mat = np.zeros((n, n))

    for i, sh_i in enumerate(data.shells):
        oi = data.ao_offsets[i]
        for j in range(i, len(data.shells)):
            sh_j = data.shells[j]
            oj = data.ao_offsets[j]
            s_b, t_b, v_b = _shell_pair_1e(
                sh_i, data.norm_coefs[i], sh_j, data.norm_coefs[j], atoms
            )
            ni, nj = s_b.shape
            s_mat[oi : oi + ni, oj : oj + nj] = s_b
            t_mat[oi : oi + ni, oj : oj + nj] = t_b
            v_mat[oi : oi + ni, oj : oj + nj] = v_b
            if i != j:
                s_mat[oj : oj + nj, oi : oi + ni] = s_b.T
                t_mat[oj : oj + nj, oi : oi + ni] = t_b.T
                v_mat[oj : oj + nj, oi : oi + ni] = v_b.T

    eri = np.zeros((n, n, n, n))
    n_shell = len(data.shells)
    for i in range(n_shell):
        for j in range(i + 1):
            for k in range(i + 1):
                l_top = j if k == i else k
                for l in range(l_top + 1):
                    blk = _shell_quartet_eri(
                        data.shells, data.norm_coefs, (i, j, k, l)
                    )
                    oi, oj = data.ao_offsets[i], data.ao_offsets[j]
                    ok, ol = data.ao_offsets[k], data.ao_offsets[l]
                    ni, nj, nk, nl = blk.shape
                    for perm_blk, (a0, b0, c0, d0) in [
                        (blk, (oi, oj, ok, ol)),
                        (blk.transpose(1, 0, 2, 3), (oj, oi, ok, ol)),
                        (blk.transpose(0, 1, 3, 2), (oi, oj, ol, ok)),
                        (blk.transpose(1, 0, 3, 2), (oj, oi, ol, ok)),
                        (blk.transpose(2, 3, 0, 1), (ok, ol, oi, oj)),
                        (blk.transpose(3, 2, 0, 1), (ol, ok, oi, oj)),
                        (blk.transpose(2, 3, 1, 0), (ok, ol, oj, oi)),
                        (blk.transpose(3, 2, 1, 0), (ol, ok, oj, oi)),
                    ]:
                        sa, sb_, sc_, sd_ = perm_blk.shape
                        eri[
                            a0 : a0 + sa,
                            b0 : b0 + sb_,
                            c0 : c0 + sc_,
                            d0 : d0 + sd_,
                        ] = perm_blk

    t = _pure_transform(data)
    if t is not None:
        s_mat = t.T @ s_mat @ t
        t_mat = t.T @ t_mat @ t
        v_mat = t.T @ v_mat @ t
        eri = np.einsum(
            "pqrs,pi,qj,rk,sl->ijkl", eri, t, t, t, t, optimize=True
        )
    return {"S": s_mat, "T": t_mat, "V": v_mat, "ERI": eri}


# Real-solid-harmonic d combination in the cartesian_powers() order
# [xx, xy, xz, yy, yz, zz]; columns m = (-2, -1, 0, +1, +2). The shells
# share one norm constant across Cartesian components (_BasisData), so the
# raw solid-harmonic coefficients apply directly; per-column scaling is
# absorbed by the generalized eigenproblem in SCF.
_PURE_D = np.array(
    [
        [0.0, 0.0, -0.5, 0.0, math.sqrt(3.0) / 2.0],  # xx
        [1.0, 0.0, 0.0, 0.0, 0.0],  # xy
        [0.0, 0.0, 0.0, 1.0, 0.0],  # xz
        [0.0, 0.0, -0.5, 0.0, -math.sqrt(3.0) / 2.0],  # yy
        [0.0, 1.0, 0.0, 0.0, 0.0],  # yz
        [0.0, 0.0, 1.0, 0.0, 0.0],  # zz
    ]
)


def _pure_transform(data: "_BasisData"):
    """Block-diagonal Cartesian->final AO transform, or None if no shell
    is spherical. Identity blocks for Cartesian shells, the 6->5 solid-
    harmonic block for pure d shells."""
    if not any(s.pure for s in data.shells):
        return None
    n_final = sum(s.n_final for s in data.shells)
    t = np.zeros((data.n_ao, n_final))
    col = 0
    for i, s in enumerate(data.shells):
        off = data.ao_offsets[i]
        if s.pure:
            assert s.angmom == 2, "only pure d implemented"
            t[off : off + 6, col : col + 5] = _PURE_D
            col += 5
        else:
            n = s.n_functions
            t[off : off + n, col : col + n] = np.eye(n)
            col += n
    return t
