// Host-side sparse kernels for structurepreservingiterativesolvers_tpu.
//
// The reference leans on native code inside its dependencies for every hot
// host-side op: scipy's C++ CSR SpMV (reference solvers.py:95,191,370) and
// SuperLU's ILU/LU factorisations (lkdvRK/Evolve.py:51-52,
// lkdv/LinearSolver.py:81).  This module provides the same capabilities
// in-tree: CSR SpMV, ILU(0) factorisation, and the L/U triangular solves.
// They serve as the host baseline for benchmarks, the oracle for validating
// the device preconditioners, and a fast `exact`-style path for fixtures.
//
// Build: g++ -O3 -march=native -shared -fPIC spkernels.cpp -o libspkernels.so

#include <cstdint>
#include <cmath>

extern "C" {

// y = A @ x for CSR(indptr, indices, data)
void csr_spmv_f64(int64_t n, const int64_t* indptr, const int64_t* indices,
                  const double* data, const double* x, double* y) {
    for (int64_t i = 0; i < n; ++i) {
        double acc = 0.0;
        for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            acc += data[p] * x[indices[p]];
        }
        y[i] = acc;
    }
}

// In-place ILU(0): factor A ≈ L·U with the sparsity of A.  `data` holds A on
// entry and the combined L (unit diagonal, strictly-lower part) and U
// (diagonal + upper) on exit.  Requires sorted column indices and a present
// diagonal.  Returns 0 on success, i+1 if a zero pivot is met at row i.
int64_t ilu0_factor_f64(int64_t n, const int64_t* indptr,
                        const int64_t* indices, double* data,
                        int64_t* diag_pos /* scratch, length n */) {
    // locate diagonals
    for (int64_t i = 0; i < n; ++i) {
        diag_pos[i] = -1;
        for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            if (indices[p] == i) { diag_pos[i] = p; break; }
        }
        if (diag_pos[i] < 0) return i + 1;
    }
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t p = indptr[i]; p < indptr[i + 1] && indices[p] < i; ++p) {
            const int64_t k = indices[p];
            const double piv = data[diag_pos[k]];
            if (piv == 0.0) return k + 1;
            const double lik = data[p] / piv;
            data[p] = lik;
            // subtract lik * U(k, j) for j > k within row i's pattern
            int64_t pi = p + 1;
            int64_t pk = diag_pos[k] + 1;
            while (pi < indptr[i + 1] && pk < indptr[k + 1]) {
                if (indices[pi] == indices[pk]) {
                    data[pi] -= lik * data[pk];
                    ++pi; ++pk;
                } else if (indices[pi] < indices[pk]) {
                    ++pi;
                } else {
                    ++pk;
                }
            }
        }
        if (data[diag_pos[i]] == 0.0) return i + 1;
    }
    return 0;
}

// Solve (L U) x = b given the combined ILU(0) factor.
void ilu0_solve_f64(int64_t n, const int64_t* indptr, const int64_t* indices,
                    const double* data, const int64_t* diag_pos,
                    const double* b, double* x) {
    // forward: L y = b (unit diagonal)
    for (int64_t i = 0; i < n; ++i) {
        double acc = b[i];
        for (int64_t p = indptr[i]; p < indptr[i + 1] && indices[p] < i; ++p) {
            acc -= data[p] * x[indices[p]];
        }
        x[i] = acc;
    }
    // backward: U x = y
    for (int64_t i = n - 1; i >= 0; --i) {
        double acc = x[i];
        for (int64_t p = indptr[i + 1] - 1; p > diag_pos[i]; --p) {
            acc -= data[p] * x[indices[p]];
        }
        x[i] = acc / data[diag_pos[i]];
    }
}

}  // extern "C"
