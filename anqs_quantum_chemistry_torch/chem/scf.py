"""Restricted Hartree-Fock with DIIS + MO integral transforms.

Standalone replacement for the reference's PySCF SCF driver
(reference: nqs/nqs/applications/quantum_chemistry/run_pyscf.py:195-240).

The port's own copy of the JAX package's ``chem/scf.py`` (numpy and scipy only,
unchanged in its arithmetic), so that the port builds molecules without
importing the JAX package.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def rhf(
    s: np.ndarray,
    h_core: np.ndarray,
    eri: np.ndarray,
    n_electrons: int,
    e_nuc: float,
    max_iter: int = 200,
    conv_tol: float = 1e-11,
    diis_size: int = 8,
    n_random_starts: int = 6,
) -> Dict:
    """Closed-shell RHF. ``eri`` in chemist notation (pq|rs).

    Runs multiple initial guesses (GWH, core, seeded random orbital sets)
    with early damping + DIIS and keeps the lowest converged solution --
    a bare core-guess DIIS loop converges to an excited SCF solution for
    e.g. N2/STO-3G (0.73 Ha above the true RHF minimum).

    Returns dict with hf_energy, mo_coeff, mo_energy, density, converged.
    """
    if n_electrons % 2:
        raise NotImplementedError("RHF requires an even electron count")
    n_occ = n_electrons // 2

    # Symmetric orthogonalization.
    s_eval, s_evec = np.linalg.eigh(s)
    keep = s_eval > 1e-10
    x = s_evec[:, keep] / np.sqrt(s_eval[keep])
    n_mo = x.shape[1]

    # Initial guesses: GWH, bare core, then random orthonormal orbitals.
    guesses = []
    k_gwh = 1.75
    diag = np.diag(h_core)
    gwh = 0.5 * k_gwh * (diag[:, None] + diag[None, :]) * s
    np.fill_diagonal(gwh, diag)
    guesses.append(gwh)
    guesses.append(h_core)
    rng_ = np.random.default_rng(20260816)
    for _ in range(n_random_starts):
        q, _ = np.linalg.qr(rng_.normal(size=(n_mo, n_mo)))
        c_rand = x @ q
        dm_rand = 2.0 * c_rand[:, :n_occ] @ c_rand[:, :n_occ].T
        j = np.einsum("pqrs,rs->pq", eri, dm_rand, optimize=True)
        k = np.einsum("prqs,rs->pq", eri, dm_rand, optimize=True)
        guesses.append(h_core + j - 0.5 * k)

    best = None
    for f_guess in guesses:
        res = _rhf_single(
            x, s, h_core, eri, n_occ, e_nuc, f_guess, max_iter, conv_tol,
            diis_size,
        )
        if res["converged"] and (
            best is None or res["hf_energy"] < best["hf_energy"] - 1e-10
        ):
            best = res
    if best is None:
        best = _rhf_single(
            x, s, h_core, eri, n_occ, e_nuc, guesses[0], max_iter, conv_tol,
            diis_size,
        )
    return best


def _rhf_single(
    x, s, h_core, eri, n_occ, e_nuc, f_init, max_iter, conv_tol, diis_size,
    damp_iters: int = 8, damp: float = 0.5,
) -> Dict:
    def solve_fock(f):
        fp = x.T @ f @ x
        e, cp = np.linalg.eigh(fp)
        c = x @ cp
        return e, c

    e_orb, c = solve_fock(f_init)
    dm = 2.0 * c[:, :n_occ] @ c[:, :n_occ].T

    errs, focks = [], []
    e_old = 0.0
    converged = False
    for it in range(max_iter):
        j = np.einsum("pqrs,rs->pq", eri, dm, optimize=True)
        k = np.einsum("prqs,rs->pq", eri, dm, optimize=True)
        f = h_core + j - 0.5 * k

        # DIIS error [F', D'] in the orthonormal basis (X^T S X = 1):
        # D' = X^T S D S X, equivalent to the usual FDS - SDF criterion.
        fp = x.T @ f @ x
        dp = np.linalg.multi_dot([x.T, s, dm, s, x])
        err = fp @ dp - dp @ fp
        errs.append(err)
        focks.append(f)
        if len(errs) > diis_size:
            errs.pop(0)
            focks.pop(0)
        if it < damp_iters:
            if len(focks) > 1:
                f = damp * focks[-2] + (1 - damp) * f
                focks[-1] = f
        elif len(errs) > 1:
            m = len(errs)
            b = -np.ones((m + 1, m + 1))
            b[m, m] = 0.0
            for i in range(m):
                for jj in range(m):
                    b[i, jj] = np.vdot(errs[i], errs[jj])
            rhs = np.zeros(m + 1)
            rhs[m] = -1.0
            try:
                w = np.linalg.solve(b, rhs)[:m]
                f = sum(wi * fi for wi, fi in zip(w, focks))
            except np.linalg.LinAlgError:
                pass

        e_orb, c = solve_fock(f)
        dm_new = 2.0 * c[:, :n_occ] @ c[:, :n_occ].T
        e_elec = 0.5 * np.sum(dm_new * (h_core + f))
        if abs(e_elec - e_old) < conv_tol and np.max(
            np.abs(dm_new - dm)
        ) < 1e-8:
            dm = dm_new
            converged = True
            break
        dm = dm_new
        e_old = e_elec

    j = np.einsum("pqrs,rs->pq", eri, dm, optimize=True)
    k = np.einsum("prqs,rs->pq", eri, dm, optimize=True)
    f = h_core + j - 0.5 * k
    e_elec = 0.5 * np.sum(dm * (h_core + f))
    return {
        "hf_energy": float(e_elec + e_nuc),
        "mo_coeff": c,
        "mo_energy": e_orb,
        "density": dm,
        "converged": converged,
        "n_occ": n_occ,
    }


def rohf(
    s: np.ndarray,
    h_core: np.ndarray,
    eri: np.ndarray,
    n_alpha: int,
    n_beta: int,
    e_nuc: float,
    max_iter: int = 300,
    conv_tol: float = 1e-11,
    diis_size: int = 8,
    n_random_starts: int = 6,
) -> Dict:
    """Restricted open-shell HF (high-spin) via the Roothaan effective
    Fock, same multi-start + damping + DIIS protocol as :func:`rhf`.

    One spatial-orbital set: the first ``n_beta`` orbitals are doubly
    occupied, the next ``n_alpha - n_beta`` singly (alpha). The effective
    Fock couples the closed/open/virtual blocks as

        R = [[Fc, Fb, Fc],
             [Fb, Fc, Fa],
             [Fc, Fa, Fc]]   (in the MO basis; Fc = (Fa+Fb)/2)

    whose self-consistent diagonalization yields the ROHF minimum (the
    converged energy is basis-independent across the standard coupling
    choices). The reference gets this from PySCF ROHF
    (reference: nqs/nqs/applications/quantum_chemistry/run_pyscf.py:
    228-240); this is the standalone equivalent.
    """
    assert n_alpha >= n_beta
    s_eval, s_evec = np.linalg.eigh(s)
    keep = s_eval > 1e-10
    x = s_evec[:, keep] / np.sqrt(s_eval[keep])
    n_mo = x.shape[1]

    guesses = []
    k_gwh = 1.75
    diag = np.diag(h_core)
    gwh = 0.5 * k_gwh * (diag[:, None] + diag[None, :]) * s
    np.fill_diagonal(gwh, diag)
    guesses.append(gwh)
    guesses.append(h_core)
    rng_ = np.random.default_rng(20260816)
    for _ in range(n_random_starts):
        q, _ = np.linalg.qr(rng_.normal(size=(n_mo, n_mo)))
        guesses.append((None, x @ q))  # random orthonormal orbital start
    best = None
    for g in guesses:
        if isinstance(g, tuple):
            c0 = g[1]
        else:
            e0, cp = np.linalg.eigh(x.T @ g @ x)
            c0 = x @ cp
        res = _rohf_single(
            x, s, h_core, eri, n_alpha, n_beta, e_nuc, c0, max_iter,
            conv_tol, diis_size,
        )
        if res["converged"] and (
            best is None or res["hf_energy"] < best["hf_energy"] - 1e-10
        ):
            best = res
    if best is None:
        e0, cp = np.linalg.eigh(x.T @ guesses[0] @ x)
        best = _rohf_single(
            x, s, h_core, eri, n_alpha, n_beta, e_nuc, x @ cp, max_iter,
            conv_tol, diis_size,
        )
    return best


def _rohf_single(
    x, s, h_core, eri, n_alpha, n_beta, e_nuc, c, max_iter, conv_tol,
    diis_size, damp_iters: int = 10, damp: float = 0.5,
) -> Dict:
    n_mo = x.shape[1]

    def build(c):
        da = c[:, :n_alpha] @ c[:, :n_alpha].T
        db = c[:, :n_beta] @ c[:, :n_beta].T
        j = np.einsum("pqrs,rs->pq", eri, da + db, optimize=True)
        ka = np.einsum("prqs,rs->pq", eri, da, optimize=True)
        kb = np.einsum("prqs,rs->pq", eri, db, optimize=True)
        fa = h_core + j - ka
        fb = h_core + j - kb
        e = 0.5 * (np.sum(da * (h_core + fa)) + np.sum(db * (h_core + fb)))
        return da, db, fa, fb, float(e)

    def effective_fock_ao(c, fa, fb):
        """Roothaan R in the current MO basis, pushed back to an AO-like
        matrix S C R C^T S so DIIS/orthonormal diagonalization apply."""
        fa_mo = c.T @ fa @ c
        fb_mo = c.T @ fb @ c
        fc_mo = 0.5 * (fa_mo + fb_mo)
        r = fc_mo.copy()
        cl = slice(0, n_beta)
        op = slice(n_beta, n_alpha)
        vt = slice(n_alpha, n_mo)
        r[cl, op] = fb_mo[cl, op]
        r[op, cl] = fb_mo[op, cl]
        r[op, vt] = fa_mo[op, vt]
        r[vt, op] = fa_mo[vt, op]
        sc = s @ c
        return sc @ r @ sc.T

    errs, focks = [], []
    e_old = 0.0
    converged = False
    da, db, fa, fb, e_elec = build(c)
    for it in range(max_iter):
        f_eff = effective_fock_ao(c, fa, fb)
        fp = x.T @ f_eff @ x
        dp = np.linalg.multi_dot([x.T, s, da + db, s, x])
        err = fp @ dp - dp @ fp
        errs.append(err)
        focks.append(f_eff)
        if len(errs) > diis_size:
            errs.pop(0)
            focks.pop(0)
        if it < damp_iters:
            if len(focks) > 1:
                f_eff = damp * focks[-2] + (1 - damp) * f_eff
                focks[-1] = f_eff
        elif len(errs) > 1:
            m = len(errs)
            b = -np.ones((m + 1, m + 1))
            b[m, m] = 0.0
            for i in range(m):
                for jj in range(m):
                    b[i, jj] = np.vdot(errs[i], errs[jj])
            rhs = np.zeros(m + 1)
            rhs[m] = -1.0
            try:
                w = np.linalg.solve(b, rhs)[:m]
                f_eff = sum(wi * fi for wi, fi in zip(w, focks))
            except np.linalg.LinAlgError:
                pass

        e_orb, cp = np.linalg.eigh(x.T @ f_eff @ x)
        c = x @ cp
        da, db, fa, fb, e_elec = build(c)
        if abs(e_elec - e_old) < conv_tol and it > damp_iters:
            converged = True
            break
        e_old = e_elec

    e_orb = np.diag(c.T @ effective_fock_ao(c, fa, fb) @ c)
    return {
        "hf_energy": float(e_elec + e_nuc),
        "mo_coeff": c,
        "mo_energy": np.asarray(e_orb, dtype=float),
        "density": da + db,
        "converged": converged,
        "n_occ": n_alpha,
        "n_alpha": n_alpha,
        "n_beta": n_beta,
    }


def mo_integrals(h_core: np.ndarray, eri: np.ndarray, mo_coeff: np.ndarray):
    """AO -> MO: returns (h_mo, eri_mo) with eri in chemist (pq|rs)."""
    c = mo_coeff
    h_mo = c.T @ h_core @ c
    eri_mo = np.einsum(
        "pqrs,pi,qj,rk,sl->ijkl", eri, c, c, c, c, optimize=True
    )
    return h_mo, eri_mo


def spin_orbital_integrals(h_mo: np.ndarray, eri_mo: np.ndarray):
    """Spatial MO -> interleaved spin-orbital integrals.

    Spin-orbital ``2i`` is alpha-i, ``2i+1`` is beta-i (the JW qubit order the
    reference uses; see SpinHalfProjectionSymmetry even/odd convention,
    reference: .../spin_half_projection_symmetry.py:47-53).

    Returns (h1, v_phys) where the Hamiltonian is
      H = sum h1[p,q] a+_p a_q + 1/2 sum v_phys[p,q,r,s] a+_p a+_q a_s a_r
    with v_phys[p,q,r,s] = <pq|rs> (physicist notation).
    """
    n = h_mo.shape[0]
    n_so = 2 * n
    h1 = np.zeros((n_so, n_so))
    spat = np.arange(n_so) // 2
    spin = np.arange(n_so) % 2
    same_spin = spin[:, None] == spin[None, :]
    h1 = np.where(same_spin, h_mo[spat[:, None], spat[None, :]], 0.0)

    # <pq|rs> = (pr|qs)_spatial with spin delta(p,r) delta(q,s).
    pr = eri_mo[
        spat[:, None, None, None],
        spat[None, None, :, None],
        spat[None, :, None, None],
        spat[None, None, None, :],
    ]
    d_pr = same_spin[:, None, :, None]
    d_qs = same_spin[None, :, None, :]
    v = pr * d_pr * d_qs
    return h1, v
