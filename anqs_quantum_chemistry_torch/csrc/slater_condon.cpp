// Sparse Hamiltonian over a sorted determinant list by the Slater-Condon
// rules, from the spin-orbital integrals (host code, single-threaded).
//
// Selected CI (chem/selected_ci.py) diagonalises H restricted to a
// determinant list: 131,072 determinants for Li2O's target, 716,014 for
// its one expansion. chem/fci.py ``sparse_hamiltonian_plain`` is the
// readable Python oracle; this builder computes the same matrix about 100x
// faster and is what ``sparse_hamiltonian`` runs above 512 determinants.
//
// Interface: plain C ABI for ctypes (chem/native.py). Determinants are
// uint64 occupation bitmasks (spin-orbital p = bit p, interleaved
// alpha/beta). Integrals:
//   H = sum h1[p*n+q] a+_p a_q
//     + 0.5 * sum v[((p*n+q)*n+r)*n+s] <pq|rs> a+_p a+_q a_s a_r
//
// Build: g++ -O3 -shared -fPIC -o libslater_condon.so slater_condon.cpp

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

inline int popcount64(uint64_t x) { return __builtin_popcountll(x); }

inline int parity_between(uint64_t det, int p, int q) {
  int lo = p < q ? p : q;
  int hi = p < q ? q : p;
  uint64_t mask = ((hi > 0 ? (1ULL << hi) : 0ULL) - 1ULL) &
                  ~((1ULL << (lo + 1)) - 1ULL);
  return (popcount64(det & mask) & 1) ? -1 : 1;
}

inline int double_parity(uint64_t det, int i, int j, int a, int b) {
  // sign of <D'| a+_a a+_b a_j a_i |D>: apply a_i, a_j, a+_b, a+_a.
  int sign = 1;
  uint64_t d = det;
  const int ann[2] = {i, j};
  for (int t = 0; t < 2; ++t) {
    int o = ann[t];
    if (popcount64(d & ((1ULL << o) - 1)) & 1) sign = -sign;
    d &= ~(1ULL << o);
  }
  const int cre[2] = {b, a};
  for (int t = 0; t < 2; ++t) {
    int o = cre[t];
    if (popcount64(d & ((1ULL << o) - 1)) & 1) sign = -sign;
    d |= (1ULL << o);
  }
  return sign;
}

struct Integrals {
  const double* h1;
  const double* v;
  int n;
  double h(int p, int q) const { return h1[(size_t)p * n + q]; }
  double vv(int p, int q, int r, int s) const {
    return v[(((size_t)p * n + q) * n + r) * n + s];
  }
};

double diagonal_energy(uint64_t det, const Integrals& I) {
  double e = 0.0;
  int occ[64];
  int n_occ = 0;
  for (int p = 0; p < I.n; ++p)
    if ((det >> p) & 1) occ[n_occ++] = p;
  for (int a = 0; a < n_occ; ++a) {
    int p = occ[a];
    e += I.h(p, p);
    for (int b = 0; b < n_occ; ++b) {
      int q = occ[b];
      if (p != q) e += 0.5 * (I.vv(p, q, p, q) - I.vv(p, q, q, p));
    }
  }
  return e;
}

double single_element(uint64_t det, int p, int q, const Integrals& I) {
  // <D'| H |D> with D' = D \ p u q (p occupied in D, q not).
  double val = I.h(q, p);
  uint64_t common = det & ~(1ULL << p);
  for (int r = 0; r < I.n; ++r) {
    if ((common >> r) & 1) val += I.vv(q, r, p, r) - I.vv(q, r, r, p);
  }
  return parity_between(det, p, q) * val;
}

}  // namespace

extern "C" {

// First pass returns the exact nnz for the (symmetric, full) matrix; second
// pass (fill != 0) writes COO triplets into rows/cols/vals (caller-allocated
// with the count from the first pass). Connections are generated by
// sector-preserving single/double excitations from each determinant; the
// determinant list must be sorted ascending (binary search for indexing).
int64_t slater_condon_build(
    const uint64_t* dets, int64_t n_dets, int n_so,
    const double* h1, const double* v, double tol, int fill,
    int64_t* rows, int64_t* cols, double* vals) {
  Integrals I{h1, v, n_so};
  int64_t count = 0;

  auto index_of = [&](uint64_t d) -> int64_t {
    int64_t lo = 0, hi = n_dets;
    while (lo < hi) {
      int64_t mid = (lo + hi) >> 1;
      if (dets[mid] < d)
        lo = mid + 1;
      else
        hi = mid;
    }
    if (lo < n_dets && dets[lo] == d) return lo;
    return -1;
  };

  auto emit = [&](int64_t i, int64_t j, double e) {
    if (fill) {
      rows[count] = i;
      cols[count] = j;
      vals[count] = e;
    }
    ++count;
  };

  for (int64_t di = 0; di < n_dets; ++di) {
    uint64_t det = dets[di];
    emit(di, di, diagonal_energy(det, I));

    int occ_s[2][64], virt_s[2][64];
    int n_occ_s[2] = {0, 0}, n_virt_s[2] = {0, 0};
    for (int p = 0; p < n_so; ++p) {
      int s = p & 1;
      if ((det >> p) & 1)
        occ_s[s][n_occ_s[s]++] = p;
      else
        virt_s[s][n_virt_s[s]++] = p;
    }

    // Singles (same spin).
    for (int s = 0; s < 2; ++s) {
      for (int a = 0; a < n_occ_s[s]; ++a) {
        int p = occ_s[s][a];
        for (int b = 0; b < n_virt_s[s]; ++b) {
          int q = virt_s[s][b];
          uint64_t d2 = (det ^ (1ULL << p)) | (1ULL << q);
          int64_t dj = index_of(d2);
          if (dj < 0 || dj <= di) continue;  // upper triangle only
          double e = single_element(det, p, q, I);
          if (e > tol || e < -tol) {
            emit(di, dj, e);
            emit(dj, di, e);
          }
        }
      }
    }

    // Doubles: same-spin pairs and opposite-spin pairs.
    for (int s1 = 0; s1 < 2; ++s1) {
      for (int s2 = s1; s2 < 2; ++s2) {
        for (int a1 = 0; a1 < n_occ_s[s1]; ++a1) {
          int i0 = occ_s[s1][a1];
          int a2_start = (s1 == s2) ? a1 + 1 : 0;
          for (int a2 = a2_start; a2 < n_occ_s[s2]; ++a2) {
            int j0 = occ_s[s2][a2];
            uint64_t base = det ^ (1ULL << i0) ^ (1ULL << j0);
            for (int b1 = 0; b1 < n_virt_s[s1]; ++b1) {
              int q1 = virt_s[s1][b1];
              int b2_start = (s1 == s2) ? b1 + 1 : 0;
              for (int b2 = b2_start; b2 < n_virt_s[s2]; ++b2) {
                int q2 = virt_s[s2][b2];
                uint64_t d2 = base | (1ULL << q1) | (1ULL << q2);
                int64_t dj = index_of(d2);
                if (dj < 0 || dj <= di) continue;
                // removed {i0 < or != j0}, added {q1, q2}; use labels
                // (I=i0, J=j0, A=q1, B=q2) consistently with the parity.
                int sign = double_parity(det, i0, j0, q1, q2);
                double e =
                    sign * (I.vv(q1, q2, i0, j0) - I.vv(q1, q2, j0, i0));
                if (e > tol || e < -tol) {
                  emit(di, dj, e);
                  emit(dj, di, e);
                }
              }
            }
          }
        }
      }
    }
  }
  return count;
}

}  // extern "C"
