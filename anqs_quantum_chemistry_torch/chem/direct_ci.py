"""String-based direct CI ("sigma build") on the card: FCI far beyond eigsh.

The port's counterpart of the JAX package's ``chem/direct_ci.py``. The
sparse FCI of ``chem/fci.py`` stores H and stops at 2^16 determinants; the
Knowles-Handy/Olsen string factorisation applies H to a vector of the whole
(N_alpha, N_beta) sector without storing it, so a Davidson solve over
Li2O/STO-3G's 41,409,225 determinants runs on one card.

Factorisation (spatial orbitals, real integrals; E_kl = sum_s a+_ks a_ls):

    H = H_aa (x) I  +  I (x) H_bb  +  sum_{kl,mn} (kl|mn) E^a_kl E^b_mn

* H_aa / H_bb: the one-spin Hamiltonians (one-electron plus same-spin
  two-electron terms), dense (S, S) string matrices built once on the host
  with the port's Slater-Condon builder; applied as one matmul each.
* The mixed term: E_kl (k != l) is a partial signed permutation of the
  strings (at most one source a row), so applying it is a signed row
  gather; E_kk is the occupancy n_k. The (kl|mn) contraction over the
  n^2 pair index is one (P, P) x (P, block * S_a) matmul.

Per block of ``block`` beta strings (columns of sigma3):
  1. N[mn, Ib, :] = w_b[mn, Ib] * C^T[src_b[mn, Ib], :]     (row gather)
  2. M[kl]        = sum_mn g2[kl, mn] N[mn]                 (matmul)
  3. sigma3[Ia, Ib] = sum_kl w_a[kl, Ia] * M[kl, Ib, src_a[kl, Ia]]
     (gather along the alpha axis, weight, reduce over kl)

The host preparation (``spatial_from_spin_orbital``, ``ci_strings``,
``excitation_tables``, ``same_spin_dense``, ``interleave_parity``) is
numpy. ``make_sigma`` is the sigma in torch on the tensors' device: plain
torch ops (the JAX package has no Pallas kernel here), its products strict
float32 through ``models/precision.py`` as JAX pins ``Precision.HIGHEST``,
float64 for the final Rayleigh quotient. ``host_sigma_f64`` is its plain
numpy version, which the tests and ``chip_smoke.py`` hold it to; nothing
on the solve's path calls it. ``direct_ci_ground_state`` is JAX's Davidson
with thick restarts: float32 sigmas on H - shift (shift = the electronic
HF energy), inner products in float64, then one float64 Rayleigh quotient
on the same device over the float64 tables (JAX's quotient upcasts its
float32 tables, which leaves their rounding, 1.7e-6 Ha at OH, in the
energy). On a CUDA device every step runs there or raises.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..models.precision import matmul

# Alpha rows are padded to a multiple of this (JAX's lane padding; the
# padded rows carry zero weights).
ROW_PAD = 128
# Davidson: the most Krylov vectors before a thick restart, and the most
# iterations (JAX's defaults).
MAX_SUBSPACE = 24
MAX_ITERS = 120


# ---------------------------------------------------------------------------
# Host preparation
# ---------------------------------------------------------------------------


def spatial_from_spin_orbital(
    h1: np.ndarray, v: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Spatial MO integrals from the interleaved spin-orbital pair (even
    qubits alpha, ``v[p,q,r,s] = <pq|rs>``): ``(h_mo, g2)`` with
    ``g2[k,l,m,n] = (kl|mn)`` (chemist), from the alpha-beta block."""
    n = h1.shape[0] // 2
    a = 2 * np.arange(n)
    h_mo = h1[np.ix_(a, a)]
    # (kl|mn) = <k_a m_b | l_a n_b> = v[2k, 2m+1, 2l, 2n+1]
    g2 = v[np.ix_(a, a + 1, a, a + 1)].transpose(0, 2, 1, 3)
    return np.ascontiguousarray(h_mo), np.ascontiguousarray(g2)


def ci_strings(n_orb: int, n_elec: int) -> np.ndarray:
    """All C(n_orb, n_elec) occupation bitmasks, ascending (HF first)."""
    out = sorted(sum(1 << o for o in occ)
                 for occ in itertools.combinations(range(n_orb), n_elec))
    return np.asarray(out, np.int64)


def excitation_tables(strs: np.ndarray,
                      n_orb: int) -> Tuple[np.ndarray, np.ndarray]:
    """The signed string maps of E_kl on this string set: ``(src, w)`` of
    shape (n_orb^2, S) with row I of E_kl c = w[k n + l, I] c[src[k n + l,
    I]]. For k == l the map is the identity weighted by the occupancy n_k;
    for k != l row I is active iff k is in I and l is not, with src = I -
    k + l and the fermionic parity of a+_k a_l |src>."""
    s_num = len(strs)
    occ = ((strs[:, None] >> np.arange(n_orb)[None, :]) & 1).astype(np.int32)
    cum = np.cumsum(occ, axis=1)  # cum[:, p] = occupied orbitals <= p

    def below(rows: np.ndarray, p: int) -> np.ndarray:
        return cum[rows, p - 1] if p > 0 else np.zeros(len(rows), np.int32)

    src = np.tile(np.arange(s_num, dtype=np.int32), (n_orb * n_orb, 1))
    w = np.zeros((n_orb * n_orb, s_num), np.float32)
    for k in range(n_orb):
        for l in range(n_orb):
            kl = k * n_orb + l
            if k == l:
                w[kl] = occ[:, k]
                continue
            rows = np.nonzero((occ[:, k] == 1) & (occ[:, l] == 0))[0]
            if len(rows) == 0:
                continue
            j_idx = np.searchsorted(
                strs, strs[rows] - (1 << k) + (1 << l)).astype(np.int32)
            # Parity of a+_k a_l |J>: the count below l in J, then below k
            # in J - l.
            par = below(j_idx, l) + below(j_idx, k) - (1 if l < k else 0)
            src[kl, rows] = j_idx
            w[kl, rows] = np.where(par % 2 == 0, 1.0, -1.0)
    return src, w


def same_spin_dense(strs: np.ndarray, h1: np.ndarray,
                    v: np.ndarray) -> np.ndarray:
    """Dense float64 one-spin string Hamiltonian (one-electron plus
    same-spin two-electron terms): the strings placed on the alpha (even)
    qubits and H built by the port's Slater-Condon builder
    (``chem/fci.sparse_hamiltonian``, the C++ one above 512 strings),
    which restricted to one spin is H_ss. JAX's rounds it to float32."""
    from .fci import sparse_hamiltonian

    n_orb = h1.shape[0] // 2
    dets = np.zeros(len(strs), np.int64)
    for k in range(n_orb):
        dets += ((strs >> k) & 1) << (2 * k)
    return sparse_hamiltonian(dets, h1, v).toarray()


def _occupancy(strs: np.ndarray, n_orb: int) -> np.ndarray:
    return ((strs[:, None] >> np.arange(n_orb)[None, :]) & 1).astype(
        np.float32)


def interleave_parity(str_a: np.ndarray, str_b: np.ndarray,
                      n_orb: int) -> np.ndarray:
    """(S_a, S_b) grid of +-1 between the string basis (alpha creators
    first, then beta) and the interleaved spin-orbital basis (creators in
    ascending spin-orbital order): parity(Ia, Ib) = (-1)^(sum_{m in Ib}
    #{k in Ia : k > m}), and c_interleaved = parity * c_string."""
    occ_a = _occupancy(str_a, n_orb)
    occ_b = _occupancy(str_b, n_orb)
    above_a = occ_a.sum(axis=1, keepdims=True) - np.cumsum(occ_a, axis=1)
    crossings = above_a @ occ_b.T
    return np.where(crossings.astype(np.int64) % 2 == 0, 1.0,
                    -1.0).astype(np.float32)


def _pad_tables(src: np.ndarray, w: np.ndarray, s_pad: int):
    """``(src, w)`` padded with zero weights to ``s_pad`` strings."""
    p, s = src.shape
    src_p = np.zeros((p, s_pad), np.int32)
    w_p = np.zeros((p, s_pad), np.float32)
    src_p[:, :s] = src
    w_p[:, :s] = w
    return src_p, w_p


def padded_shape(s_alpha: int, s_beta: int,
                 block: int = 256) -> Tuple[int, int, int]:
    """(beta block, padded alpha rows, padded beta columns) of the sigma's
    grid (JAX's rule)."""
    b = min(block, max(ROW_PAD, s_beta))
    return b, -(-s_alpha // ROW_PAD) * ROW_PAD, -(-s_beta // b) * b


# ---------------------------------------------------------------------------
# The sigma on the device, and its plain version
# ---------------------------------------------------------------------------


def make_sigma(n_orb: int, s_alpha: int, s_beta: int, block: int = 256,
               dtype=torch.float32, device="cuda"):
    """The sigma closure ``sigma(c, h_a, h_b, g2p, src_a, w_a, src_b, w_b,
    shift)`` = (H - shift) c over the padded (sa_pad, sb_pad) grid, and
    (sa_pad, sb_pad).

    Every tensor must lie on ``device`` (``ValueError`` otherwise); ``c``
    and the float tables are taken in ``dtype`` (float32 for the Davidson
    matvecs, float64 for the final Rayleigh quotient), ``src_a``/``src_b``
    in int64. Each block's intermediates (three (P, block, sa_pad) arrays,
    P = n_orb^2) are freed before the next block."""
    b, sa_pad, sb_pad = padded_shape(s_alpha, s_beta, block)
    dev = torch.device(device)

    def sigma(c, h_a, h_b, g2p, src_a, w_a, src_b, w_b, shift):
        tensors = (c, h_a, h_b, g2p, src_a, w_a, src_b, w_b)
        if any(t.device.type != dev.type for t in tensors):
            raise ValueError(f"make_sigma: every operand must lie on "
                             f"{dev}, got "
                             f"{sorted({str(t.device) for t in tensors})}")
        c = c.to(dtype)
        p = g2p.shape[0]
        ct = c.T.contiguous()  # (sb_pad, sa_pad)
        s3 = torch.empty_like(c)
        for cols in range(0, sb_pad, b):
            # 1. Row-gather C^T through the beta maps: N[mn, r, Ja].
            n_blk = ct.index_select(0, src_b[:, cols:cols + b].reshape(-1))
            n_blk = n_blk.view(p, b, sa_pad)
            n_blk.mul_(w_b[:, cols:cols + b, None].to(dtype))
            # 2. The integral contraction over the pair index.
            m_blk = matmul(g2p.to(dtype), n_blk.view(p, -1)).view(
                p, b, sa_pad)
            del n_blk
            # 3. Apply the alpha maps along the alpha axis, weight, reduce
            # over kl.
            picked = torch.gather(m_blk, 2,
                                  src_a[:, None, :].expand(p, b, sa_pad))
            del m_blk
            picked.mul_(w_a[:, None, :].to(dtype))
            s3[:, cols:cols + b] = picked.sum(0).T
            del picked
        s1 = matmul(h_a.to(dtype), c)
        s2 = matmul(c, h_b.to(dtype).T)
        return s1 + s2 + s3 - shift * c

    return sigma, sa_pad, sb_pad


def host_sigma_f64(c, h_a, h_b, g2p, src_a, w_a, src_b, w_b,
                   block: int = 64) -> np.ndarray:
    """The plain float64 numpy version of the sigma (H c, no shift; JAX
    ``host_sigma_f64``), blocked over beta columns; operands padded or
    not alike."""
    c = np.asarray(c, np.float64)
    s1 = np.asarray(h_a, np.float64) @ c
    s2 = c @ np.asarray(h_b, np.float64).T
    g2p = np.asarray(g2p, np.float64)
    w_a64 = np.asarray(w_a, np.float64)
    w_b64 = np.asarray(w_b, np.float64)
    src_a = np.asarray(src_a)
    src_b = np.asarray(src_b)
    s3 = np.zeros_like(c)
    ct = np.ascontiguousarray(c.T)
    p_num = g2p.shape[0]
    sb = c.shape[1]
    for cols in range(0, sb, block):
        b = min(block, sb - cols)
        n_blk = ct[src_b[:, cols:cols + b]] * w_b64[:, cols:cols + b, None]
        m_blk = (g2p @ n_blk.reshape(p_num, -1)).reshape(p_num, b, -1)
        picked = np.take_along_axis(m_blk.transpose(0, 2, 1),
                                    src_a[:, :, None], axis=1)
        s3[:, cols:cols + b] = np.einsum("ps,psb->sb", w_a64, picked)
    return s1 + s2 + s3


@dataclasses.dataclass
class SigmaOperands:
    """The sigma's tables on the device, padded: the string Hamiltonians
    ``h_a``/``h_b`` and the pair integrals ``g2p`` (P, P) in float64, the
    maps ``src_a``/``w_a`` and ``src_b``/``w_b`` (P, s_pad), the float32
    preconditioner diagonal ``diag`` of H - shift (1e6 on padding), and
    ``shift``, the electronic HF energy."""

    h_a: torch.Tensor
    h_b: torch.Tensor
    g2p: torch.Tensor
    src_a: torch.Tensor
    w_a: torch.Tensor
    src_b: torch.Tensor
    w_b: torch.Tensor
    diag: torch.Tensor
    shift: float
    s_alpha: int
    s_beta: int

    def tables(self, dtype=torch.float32):
        """The sigma's table arguments in ``dtype`` (float32 rounds the
        float64 tables once, as JAX's host build does)."""
        return (self.h_a.to(dtype), self.h_b.to(dtype), self.g2p.to(dtype),
                self.src_a, self.w_a.to(dtype), self.src_b,
                self.w_b.to(dtype))


def sigma_operands(h1: np.ndarray, v: np.ndarray, n_alpha: int,
                   n_beta: int, block: int = 256,
                   device="cuda") -> SigmaOperands:
    """Build the tables of the (n_alpha, n_beta) sector on the host and
    move them to ``device`` (float64 Hamiltonians and pair integrals,
    float32 weights, int64 maps)."""
    n_orb = h1.shape[0] // 2
    str_a = ci_strings(n_orb, n_alpha)
    str_b = str_a if n_beta == n_alpha else ci_strings(n_orb, n_beta)
    s_a, s_b = len(str_a), len(str_b)
    _, sa_pad, sb_pad = padded_shape(s_a, s_b, block)

    _, g2 = spatial_from_spin_orbital(h1, v)
    g2p = g2.reshape(n_orb * n_orb, n_orb * n_orb)
    h_a = same_spin_dense(str_a, h1, v)
    h_b = h_a if str_b is str_a else same_spin_dense(str_b, h1, v)
    src_a, w_a = excitation_tables(str_a, n_orb)
    src_b, w_b = ((src_a, w_a) if str_b is str_a
                  else excitation_tables(str_b, n_orb))

    # Shift: the electronic HF energy, the diagonal element of the HF
    # determinant, so sigma lives on the correlation scale. Summed from the
    # float32 string diagonals as JAX does, so both shift alike.
    jmat = np.einsum("kkmm->km", g2)  # (kk|mm)
    diag = (np.diag(h_a).astype(np.float32)[:, None]
            + np.diag(h_b).astype(np.float32)[None, :]
            + _occupancy(str_a, n_orb) @ jmat @ _occupancy(str_b, n_orb).T
            ).astype(np.float32)
    shift = float(diag[0, 0])

    def pad(x, rows, cols, fill=0.0):
        out = np.full((rows, cols), fill, x.dtype)
        out[:x.shape[0], :x.shape[1]] = x
        return out

    # Padding: the preconditioner parked far from the spectrum.
    diag_p = pad(diag - np.float32(shift), sa_pad, sb_pad, 1e6)
    dev = torch.device(device)

    def put(x, dtype=torch.float64):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dtype)

    src_ap, w_ap = _pad_tables(src_a, w_a, sa_pad)
    src_bp, w_bp = _pad_tables(src_b, w_b, sb_pad)
    h_ad = put(pad(h_a, sa_pad, sa_pad))
    return SigmaOperands(
        h_a=h_ad,
        h_b=h_ad if h_b is h_a and sa_pad == sb_pad
        else put(pad(h_b, sb_pad, sb_pad)),
        g2p=put(g2p), src_a=put(src_ap, torch.int64),
        w_a=put(w_ap, torch.float32), src_b=put(src_bp, torch.int64),
        w_b=put(w_bp, torch.float32), diag=put(diag_p, torch.float32),
        shift=shift, s_alpha=s_a, s_beta=s_b,
    )


# ---------------------------------------------------------------------------
# Davidson
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DirectCIResult:
    energy: float  # total (with e_nuc), the float64 Rayleigh quotient
    # over the float64 tables
    energy_f32: float  # the last float32 Ritz value (+ e_nuc)
    residual: float
    iterations: int
    ipr: float
    coeffs: Optional[np.ndarray]  # (S_a, S_b) float32, if requested


def direct_ci_ground_state(
    h1: np.ndarray,
    v: np.ndarray,
    n_alpha: int,
    n_beta: int,
    e_nuc: float = 0.0,
    block: int = 256,
    tol: float = 3e-4,
    return_coeffs: bool = False,
    verbose: Callable[[str], None] = lambda s: None,
    device="cuda",
) -> DirectCIResult:
    """Ground state of the (n_alpha, n_beta) sector by direct CI (JAX
    ``direct_ci_ground_state``): Davidson with thick restarts on H - shift
    with float32 sigmas on ``device``, float64 inner products, the
    diagonal preconditioner, two passes of modified Gram-Schmidt, then
    one float64 Rayleigh quotient over the float64 tables on the same
    device for the energy.
    ``block``: beta strings a sigma block (256 at Li2O keeps each block
    intermediate at 1.5 GB in float32, 3 GB in float64; 128 and 512 take
    the same time on an H100)."""
    dev = torch.device(device)
    ops = sigma_operands(h1, v, n_alpha, n_beta, block, dev)
    n_orb = h1.shape[0] // 2
    sigma, sa_pad, sb_pad = make_sigma(n_orb, ops.s_alpha, ops.s_beta,
                                       block, torch.float32, dev)
    tabs32 = ops.tables(torch.float32)

    def mv(c):
        return sigma(c, *tabs32, ops.shift)

    def dot(x, y) -> float:
        return float(torch.dot(x.to(torch.float64).reshape(-1),
                               y.to(torch.float64).reshape(-1)))

    f32 = np.float32
    v0 = torch.zeros((sa_pad, sb_pad), dtype=torch.float32, device=dev)
    v0[0, 0] = 1.0
    basis = [v0]
    h_basis = [mv(v0)]
    theta_old = np.inf
    theta = dot(basis[0], h_basis[0])
    ritz = v0
    res_norm = np.inf
    it = 0
    for it in range(1, MAX_ITERS + 1):
        m = len(basis)
        hm = np.zeros((m, m), np.float64)
        for i in range(m):
            for j in range(i, m):
                hm[i, j] = hm[j, i] = dot(basis[i], h_basis[j])
        evals, evecs = np.linalg.eigh(hm)
        theta, y = float(evals[0]), evecs[:, 0]
        ritz = sum(float(y[i]) * basis[i] for i in range(m))
        h_ritz = sum(float(y[i]) * h_basis[i] for i in range(m))
        r = h_ritz - theta * ritz
        res_norm = float(np.sqrt(max(dot(r, r), 0.0)))
        verbose(f"davidson it {it:3d} m {m:2d} "
                f"E {theta + ops.shift + e_nuc:+.8f} res {res_norm:.2e}")
        if res_norm < tol and abs(theta - theta_old) < 1e-7:
            break
        theta_old = theta
        # Preconditioned correction, orthogonalised (2x MGS).
        t = r / (ops.diag - f32(theta) + 1e-6)
        del r
        if m + 1 > MAX_SUBSPACE:
            nrm = f32(np.sqrt(dot(ritz, ritz)))
            basis, h_basis = [ritz / nrm], [h_ritz / nrm]
        del h_ritz
        for _ in range(2):
            for bvec in basis:
                t = t - f32(dot(bvec, t)) * bvec
        t_norm = np.sqrt(max(dot(t, t), 0.0))
        if t_norm < 1e-12:
            break
        t = t / f32(t_norm)
        basis.append(t)
        h_basis.append(mv(t))
    del basis, h_basis
    ritz = ritz / f32(np.sqrt(dot(ritz, ritz)))

    energy_f32 = theta + ops.shift + e_nuc
    del tabs32
    sigma64, _, _ = make_sigma(n_orb, ops.s_alpha, ops.s_beta, block,
                               torch.float64, dev)
    c64 = ritz.to(torch.float64)
    hc = sigma64(c64, *ops.tables(torch.float64), 0.0)
    energy = dot(c64, hc) / dot(c64, c64) + e_nuc
    del hc
    ipr_val = float(torch.sum(ritz.to(torch.float64) ** 4))
    coeffs = None
    if return_coeffs:
        coeffs = ritz[:ops.s_alpha, :ops.s_beta].cpu().numpy()
    return DirectCIResult(energy=float(energy), energy_f32=float(energy_f32),
                          residual=res_norm, iterations=it, ipr=ipr_val,
                          coeffs=coeffs)
