"""Spin-orbital CCSD and perturbative (T) (numpy einsum).

Completes the post-HF baseline ladder the reference obtains from PySCF
(reference: nqs/nqs/applications/quantum_chemistry/run_pyscf.py:266-297 runs
CCSD/CCSD(T)). Standard spin-orbital equations (Stanton, Gauss, Watts,
Bartlett, JCP 94, 4334 (1991)) with antisymmetrized physicist integrals
``<pq||rs> = v[p,q,r,s] - v[p,q,s,r]``.

Exactness checks used by the test suite: CCSD == FCI for 2-electron systems;
E_MP2 emerges from the first CCSD iteration.

The port's own copy of the JAX package's ``chem/cc.py`` (numpy and scipy only,
unchanged in its arithmetic), so that the port builds molecules without
importing the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def ccsd(
    h1: np.ndarray,
    v: np.ndarray,
    hf_det: int,
    e_nuc: float = 0.0,
    max_iter: int = 200,
    conv_tol: float = 1e-9,
    damping: float = 0.3,
) -> Tuple[float, np.ndarray, np.ndarray, dict]:
    """Returns (E_CCSD_total, t1, t2, info). Indices: occ then virt blocks."""
    n_so = h1.shape[0]
    occ = [p for p in range(n_so) if (hf_det >> p) & 1]
    virt = [p for p in range(n_so) if not (hf_det >> p) & 1]
    n_o, n_v = len(occ), len(virt)

    v_anti = v - v.transpose(0, 1, 3, 2)
    order = occ + virt
    v_anti = v_anti[np.ix_(order, order, order, order)]
    h_ord = h1[np.ix_(order, order)]
    o = slice(0, n_o)
    u = slice(n_o, n_so)

    f = h_ord + np.einsum("piqi->pq", v_anti[:, o, :, o])
    e_hf = (
        np.einsum("ii->", h_ord[o, o])
        + 0.5 * np.einsum("ijij->", v_anti[o, o, o, o])
        + e_nuc
    )

    f_o = np.diag(f)[o]
    f_v = np.diag(f)[u]
    d1 = f_o[:, None] - f_v[None, :]
    d2 = (
        f_o[:, None, None, None]
        + f_o[None, :, None, None]
        - f_v[None, None, :, None]
        - f_v[None, None, None, :]
    )

    t1 = f[o, u] / d1
    t2 = v_anti[o, o, u, u] / d2
    e_mp2 = 0.25 * np.einsum("ijab,ijab->", v_anti[o, o, u, u], t2)

    def energy(t1, t2):
        e = np.einsum("ia,ia->", f[o, u], t1)
        e += 0.25 * np.einsum("ijab,ijab->", v_anti[o, o, u, u], t2)
        e += 0.5 * np.einsum(
            "ijab,ia,jb->", v_anti[o, o, u, u], t1, t1
        )
        return e

    e_old = energy(t1, t2)
    converged = False
    for it in range(max_iter):
        tau_t = t2 + 0.5 * (
            np.einsum("ia,jb->ijab", t1, t1)
            - np.einsum("ib,ja->ijab", t1, t1)
        )
        tau = t2 + (
            np.einsum("ia,jb->ijab", t1, t1)
            - np.einsum("ib,ja->ijab", t1, t1)
        )

        fae = f[u, u] - np.diag(np.diag(f[u, u]))
        fae = fae - 0.5 * np.einsum("me,ma->ae", f[o, u], t1)
        fae += np.einsum("mf,mafe->ae", t1, v_anti[o, u, u, u])
        fae -= 0.5 * np.einsum(
            "mnaf,mnef->ae", tau_t, v_anti[o, o, u, u]
        )

        fmi = f[o, o] - np.diag(np.diag(f[o, o]))
        fmi = fmi + 0.5 * np.einsum("ie,me->mi", t1, f[o, u])
        fmi += np.einsum("ne,mnie->mi", t1, v_anti[o, o, o, u])
        fmi += 0.5 * np.einsum(
            "inef,mnef->mi", tau_t, v_anti[o, o, u, u]
        )

        fme = f[o, u] + np.einsum(
            "nf,mnef->me", t1, v_anti[o, o, u, u]
        )

        wmnij = v_anti[o, o, o, o].copy()
        tmp = np.einsum("je,mnie->mnij", t1, v_anti[o, o, o, u])
        wmnij += tmp - tmp.transpose(0, 1, 3, 2)
        wmnij += 0.25 * np.einsum(
            "ijef,mnef->mnij", tau, v_anti[o, o, u, u]
        )

        wabef = v_anti[u, u, u, u].copy()
        tmp = np.einsum("mb,amef->abef", t1, v_anti[u, o, u, u])
        wabef += -tmp + tmp.transpose(1, 0, 2, 3)
        wabef += 0.25 * np.einsum(
            "mnab,mnef->abef", tau, v_anti[o, o, u, u]
        )

        wmbej = v_anti[o, u, u, o].copy()
        wmbej += np.einsum("jf,mbef->mbej", t1, v_anti[o, u, u, u])
        wmbej -= np.einsum("nb,mnej->mbej", t1, v_anti[o, o, u, o])
        wmbej -= np.einsum(
            "jnfb,mnef->mbej",
            0.5 * t2 + np.einsum("jf,nb->jnfb", t1, t1),
            v_anti[o, o, u, u],
        )

        # T1 equations.
        t1_new = f[o, u].copy()
        t1_new += np.einsum("ie,ae->ia", t1, fae)
        t1_new -= np.einsum("ma,mi->ia", t1, fmi)
        t1_new += np.einsum("imae,me->ia", t2, fme)
        t1_new -= np.einsum("nf,naif->ia", t1, v_anti[o, u, o, u])
        t1_new -= 0.5 * np.einsum(
            "imef,maef->ia", t2, v_anti[o, u, u, u]
        )
        t1_new -= 0.5 * np.einsum(
            "mnae,nmei->ia", t2, v_anti[o, o, u, o]
        )
        t1_new = t1_new / d1

        # T2 equations.
        t2_new = v_anti[o, o, u, u].copy()
        tmp = np.einsum(
            "ijae,be->ijab",
            t2,
            fae - 0.5 * np.einsum("mb,me->be", t1, fme),
        )
        t2_new += tmp - tmp.transpose(0, 1, 3, 2)
        tmp = np.einsum(
            "imab,mj->ijab",
            t2,
            fmi + 0.5 * np.einsum("je,me->mj", t1, fme),
        )
        t2_new += -tmp + tmp.transpose(1, 0, 2, 3)
        t2_new += 0.5 * np.einsum("mnab,mnij->ijab", tau, wmnij)
        t2_new += 0.5 * np.einsum("ijef,abef->ijab", tau, wabef)
        tmp = np.einsum("imae,mbej->ijab", t2, wmbej)
        tmp -= np.einsum(
            "ie,ma,mbej->ijab", t1, t1, v_anti[o, u, u, o]
        )
        tmp = (
            tmp
            - tmp.transpose(1, 0, 2, 3)
            - tmp.transpose(0, 1, 3, 2)
            + tmp.transpose(1, 0, 3, 2)
        )
        t2_new += tmp
        tmp = np.einsum("ie,abej->ijab", t1, v_anti[u, u, u, o])
        t2_new += tmp - tmp.transpose(1, 0, 2, 3)
        tmp = np.einsum("ma,mbij->ijab", t1, v_anti[o, u, o, o])
        t2_new += -tmp + tmp.transpose(0, 1, 3, 2)
        t2_new = t2_new / d2

        t1 = damping * t1 + (1 - damping) * t1_new
        t2 = damping * t2 + (1 - damping) * t2_new
        e_new = energy(t1, t2)
        if abs(e_new - e_old) < conv_tol:
            e_old = e_new
            converged = True
            break
        e_old = e_new

    info = {
        "converged": converged,
        "e_hf": float(e_hf),
        "e_mp2": float(e_hf + e_mp2),
        "e_corr": float(e_old),
    }
    return float(e_hf + e_old), t1, t2, info


def ccsd_t_correction(
    h1: np.ndarray, v: np.ndarray, hf_det: int, t1: np.ndarray,
    t2: np.ndarray,
) -> float:
    """Perturbative triples E(T) from converged CCSD amplitudes."""
    n_so = h1.shape[0]
    occ = [p for p in range(n_so) if (hf_det >> p) & 1]
    virt = [p for p in range(n_so) if not (hf_det >> p) & 1]
    n_o, n_v = len(occ), len(virt)
    order = occ + virt
    v_anti = (v - v.transpose(0, 1, 3, 2))[
        np.ix_(order, order, order, order)
    ]
    h_ord = h1[np.ix_(order, order)]
    o = slice(0, n_o)
    u = slice(n_o, n_so)
    f = h_ord + np.einsum("piqi->pq", v_anti[:, o, :, o])
    f_o = np.diag(f)[o]
    f_v = np.diag(f)[u]

    d3 = (
        f_o[:, None, None, None, None, None]
        + f_o[None, :, None, None, None, None]
        + f_o[None, None, :, None, None, None]
        - f_v[None, None, None, :, None, None]
        - f_v[None, None, None, None, :, None]
        - f_v[None, None, None, None, None, :]
    )

    def p_ijk(x):  # antisymmetrize i/(jk): x - swap(i,j) - swap(i,k)
        return (
            x - x.transpose(1, 0, 2, 3, 4, 5) - x.transpose(2, 1, 0, 3, 4, 5)
        )

    def p_abc(x):
        return (
            x - x.transpose(0, 1, 2, 4, 3, 5) - x.transpose(0, 1, 2, 5, 4, 3)
        )

    # Disconnected: t3d = P(i/jk) P(a/bc) t1_ia <jk||bc> / d3
    t3d = np.einsum("ia,jkbc->ijkabc", t1, v_anti[o, o, u, u])
    t3d = p_ijk(p_abc(t3d))

    # Connected: t3c = P(i/jk) P(a/bc) [ sum_e t_jk^ae <ei||bc>
    #                                   - sum_m t_im^bc <ma||jk> ] / d3
    x = np.einsum("jkae,eibc->ijkabc", t2, v_anti[u, o, u, u])
    x -= np.einsum("imbc,majk->ijkabc", t2, v_anti[o, u, o, o])
    t3c = p_ijk(p_abc(x))

    e_t = np.einsum("ijkabc,ijkabc->", t3c * (t3c + t3d), 1.0 / d3) / 36.0
    return float(e_t)
