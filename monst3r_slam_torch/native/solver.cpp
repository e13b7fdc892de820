// Host-side float64 linear algebra for the pose-graph backend.
//
// The port's copy of the JAX package's native solver, which replaces the
// reference's Eigen SimplicialLLT host solve (backend/src/gn_kernels.cu:57-159
// SparseBlock): the Gauss-Newton normal equations assembled on the device
// are solved here in double precision. SPD systems need no pivoting:
//   - dense Cholesky (LL^T) with a diagonal jitter fallback
//   - triangular solves
// exposed with a C ABI for ctypes.
//
// Build: monst3r_slam_torch/native/build.py (g++ -O3 -shared -fPIC, into
// build/native/ at the repository root).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Cholesky factorization in place (lower). Returns 0 on success, k>0 if the
// leading minor of order k is not positive definite.
int64_t cholesky_f64(double* a, int64_t n) {
  for (int64_t j = 0; j < n; ++j) {
    double d = a[j * n + j];
    for (int64_t k = 0; k < j; ++k) d -= a[j * n + k] * a[j * n + k];
    if (d <= 0.0 || !std::isfinite(d)) return j + 1;
    d = std::sqrt(d);
    a[j * n + j] = d;
    const double inv = 1.0 / d;
    for (int64_t i = j + 1; i < n; ++i) {
      double s = a[i * n + j];
      const double* ri = a + i * n;
      const double* rj = a + j * n;
      for (int64_t k = 0; k < j; ++k) s -= ri[k] * rj[k];
      a[i * n + j] = s * inv;
    }
  }
  // zero the strict upper triangle
  for (int64_t i = 0; i < n; ++i)
    for (int64_t j = i + 1; j < n; ++j) a[i * n + j] = 0.0;
  return 0;
}

// Solve A x = b for SPD A (row-major n*n), b (n). Adds `jitter`*max_diag*I
// and retries (up to 3x10 growth) if the factorization fails: the
// reference zeroes the step there (gn_kernels.cu:147-150), this recovers.
// Returns 0 on success with x the solution; 1 with x zeroed.
int64_t solve_spd_f64(const double* a_in, const double* b, double* x,
                      int64_t n, double jitter) {
  std::vector<double> a(static_cast<size_t>(n) * n);
  double max_diag = 0.0;
  for (int64_t i = 0; i < n; ++i)
    max_diag = std::fmax(max_diag, std::fabs(a_in[i * n + i]));
  if (max_diag == 0.0) max_diag = 1.0;

  double eps = jitter;
  for (int attempt = 0; attempt < 4; ++attempt) {
    std::memcpy(a.data(), a_in, sizeof(double) * n * n);
    for (int64_t i = 0; i < n; ++i) a[i * n + i] += eps * max_diag;
    if (cholesky_f64(a.data(), n) == 0) {
      // forward: L y = b
      for (int64_t i = 0; i < n; ++i) {
        double s = b[i];
        for (int64_t k = 0; k < i; ++k) s -= a[i * n + k] * x[k];
        x[i] = s / a[i * n + i];
      }
      // backward: L^T x = y
      for (int64_t i = n - 1; i >= 0; --i) {
        double s = x[i];
        for (int64_t k = i + 1; k < n; ++k) s -= a[k * n + i] * x[k];
        x[i] = s / a[i * n + i];
      }
      return 0;
    }
    eps = (eps == 0.0) ? 1e-10 : eps * 10.0;
  }
  std::memset(x, 0, sizeof(double) * n);
  return 1;
}

}  // extern "C"
