// Native host-side schedule builder for the multilevel Picard solvers.
//
// Computes, in float64 C++:
//   - the inverse-Gamma level tables (Lambert-W via Halley iteration),
//   - Gauss-Legendre nodes/weights (Newton iteration on Legendre polynomials),
//   - the recursive evaluation counters (exact 64-bit arithmetic; the Python
//     recursion overflows Python-call depth/time for deep (n, M) schedules).
//
// Exposed as a C ABI consumed through ctypes by scasml_gp.utils.native;
// semantics mirror scasml_gp/picard/schedule.py (which remains the
// reference implementation and fallback).  Capability parity target:
// reference solvers/MLP.py:57-139 (inverse_gamma, lgwt, approx_parameters).

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

// Principal-branch Lambert W via Halley iteration (fp64).
double lambert_w0(double x) {
  double w = (x < 1.0) ? x : std::log(x > 0 ? x : 1e-300);
  if (x < -0.3) w = -0.3;  // near the branch point -1/e, start left
  for (int i = 0; i < 64; ++i) {
    double ew = std::exp(w);
    double f = w * ew - x;
    double denom = ew * (w + 1.0) - (w + 2.0) * f / (2.0 * w + 2.0);
    double step = f / denom;
    w -= step;
    if (std::fabs(step) < 1e-15 * (1.0 + std::fabs(w))) break;
  }
  return w;
}

// Approximate inverse of the Gamma function (reference solvers/MLP.py:57-69).
double inverse_gamma(double g) {
  const double c = 0.036534;
  double L = std::log((g + c) / std::sqrt(2.0 * M_PI));
  return L / lambert_w0(L / M_E) + 0.5;
}

// Legendre polynomial P_n and derivative at x (recurrence).
void legendre(int n, double x, double* p, double* dp) {
  double p0 = 1.0, p1 = x;
  if (n == 0) { *p = p0; *dp = 0.0; return; }
  for (int k = 2; k <= n; ++k) {
    double p2 = ((2.0 * k - 1.0) * x * p1 - (k - 1.0) * p0) / k;
    p0 = p1;
    p1 = p2;
  }
  *p = p1;
  *dp = n * (x * p1 - p0) / (x * x - 1.0);
}

}  // namespace

extern "C" {

// Gauss-Legendre nodes/weights on [a, b], ascending. x, w: length npts.
void leggauss(int npts, double a, double b, double* x, double* w) {
  for (int i = 0; i < npts; ++i) {
    // Chebyshev initial guess, descending in cos -> ascending after map below
    double t = std::cos(M_PI * (i + 0.75) / (npts + 0.5));
    double p, dp;
    for (int it = 0; it < 100; ++it) {
      legendre(npts, t, &p, &dp);
      double step = p / dp;
      t -= step;
      if (std::fabs(step) < 1e-15) break;
    }
    legendre(npts, t, &p, &dp);
    int j = npts - 1 - i;  // cos ordering is descending; store ascending
    x[j] = 0.5 * (b - a) * t + 0.5 * (b + a);
    w[j] = (b - a) / ((1.0 - t * t) * dp * dp);
  }
}

// Level tables (reference approx_parameters, solvers/MLP.py:111-139).
// Mf: (rhomax, rhomax); Mg: (rhomax, rhomax+1); Q: (rhomax, rhomax),
// row-major int64. c, w: (qmax, qmax) fp64 where qmax = max(Q) is returned.
int64_t picard_tables(int rhomax, double T, int64_t* Mf, int64_t* Mg,
                      int64_t* Q, double* c, double* w, int64_t qcap) {
  for (int rho = 1; rho <= rhomax; ++rho) {
    for (int k = 1; k <= rho; ++k) {
      Q[(rho - 1) * rhomax + (k - 1)] =
          (int64_t)std::llround(inverse_gamma(std::pow(rho, k / 2.0)));
      Mf[(rho - 1) * rhomax + (k - 1)] =
          (int64_t)std::llround(std::pow(rho, k / 2.0));
      Mg[(rho - 1) * (rhomax + 1) + (k - 1)] =
          (int64_t)std::llround(std::pow((double)rho, k - 1.0));
    }
    Mg[(rho - 1) * (rhomax + 1) + rho] =
        (int64_t)std::llround(std::pow((double)rho, (double)rho));
  }
  int64_t qmax = 1;
  for (int i = 0; i < rhomax * rhomax; ++i) qmax = Q[i] > qmax ? Q[i] : qmax;
  if (qmax > qcap) return -qmax;  // caller must re-allocate
  // c and w are (qcap, qcap) row-major in the caller; write with stride qcap.
  std::vector<double> xk(qmax), wk(qmax);
  for (int64_t k = 1; k <= qmax; ++k) {
    leggauss((int)k, 0.0, T, xk.data(), wk.data());
    for (int64_t i = 0; i < k; ++i) {
      c[i * qcap + (k - 1)] = xk[i];
      w[i * qcap + (k - 1)] = wk[i];
    }
  }
  return qmax;
}

// Evaluation counter, quadrature variant (semantics of
// scasml_gp/picard/schedule.py::count_evaluations_quadrature).
int64_t count_quadrature(int n, int rho, const int64_t* Mf, const int64_t* Mg,
                         const int64_t* Q, int rhomax, int count_fg) {
  std::vector<int64_t> memo(n + 1, -1);
  // iterative bottom-up over levels
  for (int lvl = 0; lvl <= n; ++lvl) {
    int64_t total = Mg[(rho - 1) * (rhomax + 1) + lvl] + (count_fg ? 1 : 0);
    if (lvl > 0) {
      for (int l = 0; l < lvl; ++l) {
        int64_t q = Q[(rho - 1) * rhomax + (lvl - l - 1)];
        int64_t mf = Mf[(rho - 1) * rhomax + (lvl - l - 1)];
        for (int64_t k = 0; k < q; ++k) {
          total += memo[l] + mf + (count_fg ? 1 : 0);
          if (l) total += memo[l - 1] + mf + (count_fg ? 1 : 0);
        }
      }
    }
    memo[lvl] = total;
  }
  return memo[n];
}

// Evaluation counter, full-history variant (semantics of
// count_evaluations_full_history; scasml_variant uses MC_g in the loop).
int64_t count_full_history(int n, int64_t M, int scasml_variant,
                           int count_fg) {
  std::vector<int64_t> memo(n + 1, 0);
  std::vector<int64_t> mpow(n + 1, 1);
  for (int i = 1; i <= n; ++i) mpow[i] = mpow[i - 1] * M;
  for (int lvl = 0; lvl <= n; ++lvl) {
    int64_t total = mpow[lvl] + (count_fg ? 1 : 0);
    for (int l = 0; l < lvl; ++l) {
      int64_t inc = scasml_variant ? mpow[lvl] : mpow[lvl - l];
      total += memo[l] + inc + (count_fg ? 1 : 0);
      if (l) total += memo[l - 1] + inc + (count_fg ? 1 : 0);
    }
    memo[lvl] = total;
  }
  return memo[n];
}

}  // extern "C"
