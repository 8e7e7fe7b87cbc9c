// Native LFA tape engine.
//
// Executes the symbol calculus recorded by prediction/native_lfa.py: a
// straight-line program over complex matrices, run independently per
// sampled frequency (OpenMP across frequencies), with BLAS zgemm for
// products, LAPACK zgetrf/zgetri for inverses and zgeev for the final
// spectral radius.  This is the framework's counterpart of the reference's
// C++ LFA Lab library (reference model_based_prediction/convergence.py
// drives it through SWIG); here the host-side analysis hot path is native
// while device compute stays in XLA.
//
// Storage is column-major (LAPACK convention).  Instructions are fixed
// 8-int64 records: [op, out, a, b, rows, cols, payload_off, payload_len];
// payloads are doubles.

#include <complex>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

using cdouble = std::complex<double>;

extern "C" {
// BLAS / LAPACK (reference netlib ABI)
void zgemm_(const char*, const char*, const int*, const int*, const int*,
            const cdouble*, const cdouble*, const int*, const cdouble*,
            const int*, const cdouble*, cdouble*, const int*);
void zgetrf_(const int*, const int*, cdouble*, const int*, int*, int*);
void zgetri_(const int*, cdouble*, const int*, const int*, cdouble*,
             const int*, int*);
void zgeev_(const char*, const char*, const int*, cdouble*, const int*,
            cdouble*, cdouble*, const int*, cdouble*, const int*, cdouble*,
            const int*, double*, int*);
}

namespace {

enum Op : int64_t {
  OP_CIRCULANT = 1,
  OP_SELECTION = 2,
  OP_EMBEDDING = 3,
  OP_DIAG = 4,
  OP_IDENTITY = 5,
  OP_ZERO = 6,
  OP_MATMUL = 7,
  OP_ADD = 8,
  OP_SUB = 9,
  OP_SCALE = 10,
  OP_INV = 11,
  OP_KRONEYE = 12,
  OP_BLOCK = 13,
  OP_EIGMAX = 14,
};

struct Instr {
  int64_t op, out, a, b, rows, cols, poff, plen;
};

struct Slot {
  std::vector<cdouble> buf;
  int rows = 0, cols = 0;
};

// O(n^2) scan; pays for itself instantly: smoother symbols and red-black
// masks are diagonal, turning their O(n^3) products/inverses into O(n^2)
bool is_diagonal(const Slot& s) {
  if (s.rows != s.cols) return false;
  const int n = s.rows;
  for (int c = 0; c < n; ++c)
    for (int r = 0; r < n; ++r)
      if (r != c && s.buf[(size_t)c * n + r] != cdouble(0.0, 0.0))
        return false;
  return true;
}

int run_theta(const double* theta, int dim, const Instr* code, int n_instr,
              const double* payload, int n_slots,
              const std::vector<int>& last_use, double* rho_out) {
  std::vector<Slot> slots(n_slots);
  double rho = 0.0;

  for (int k = 0; k < n_instr; ++k) {
    const Instr& I = code[k];
    const double* pl = payload + I.poff;
    if (I.op != OP_EIGMAX) {
      Slot& out = slots[I.out];
      out.rows = (int)I.rows;
      out.cols = (int)I.cols;
      out.buf.assign((size_t)I.rows * I.cols, cdouble(0.0, 0.0));
    }
    switch (I.op) {
      case OP_CIRCULANT: {
        // payload records: x, y, off[dim], re, im
        Slot& out = slots[I.out];
        const double scale = std::ldexp(1.0, (int)I.a);  // 2^rel
        const int rec = 2 + dim + 2;
        const int64_t n_entries = I.plen / rec;
        for (int64_t e = 0; e < n_entries; ++e) {
          const double* r = pl + e * rec;
          const int x = (int)r[0], y = (int)r[1];
          double ph = 0.0;
          for (int ax = 0; ax < dim; ++ax)
            ph += scale * theta[ax] * r[2 + ax];
          const cdouble v(r[2 + dim], r[3 + dim]);
          out.buf[(size_t)y * I.rows + x] +=
              v * cdouble(std::cos(ph), std::sin(ph));
        }
        break;
      }
      case OP_SELECTION:
      case OP_EMBEDDING: {
        Slot& out = slots[I.out];
        const double scale = std::ldexp(1.0, (int)I.a);
        double ph = 0.0;
        for (int ax = 0; ax < dim; ++ax) ph += scale * theta[ax];
        const double sgn = (I.op == OP_SELECTION) ? 1.0 : -1.0;
        const cdouble phase(std::cos(ph), sgn * std::sin(ph));
        const int64_t n_pairs = I.plen / 2;
        for (int64_t e = 0; e < n_pairs; ++e) {
          const int c = (int)pl[2 * e], f = (int)pl[2 * e + 1];
          if (I.op == OP_SELECTION)
            out.buf[(size_t)f * I.rows + c] = phase;   // (c,f) of (nc x nf)
          else
            out.buf[(size_t)c * I.rows + f] = phase;   // (f,c) of (nf x nc)
        }
        break;
      }
      case OP_DIAG: {
        Slot& out = slots[I.out];
        for (int64_t i = 0; i < I.rows; ++i)
          out.buf[(size_t)i * I.rows + i] = cdouble(pl[i], 0.0);
        break;
      }
      case OP_IDENTITY: {
        Slot& out = slots[I.out];
        for (int64_t i = 0; i < I.rows; ++i)
          out.buf[(size_t)i * I.rows + i] = cdouble(1.0, 0.0);
        break;
      }
      case OP_ZERO:
        break;  // already zero-filled
      case OP_MATMUL: {
        Slot& A = slots[I.a];
        Slot& B = slots[I.b];
        Slot& C = slots[I.out];
        const int m = A.rows, n = B.cols, kk = A.cols;
        if (kk != B.rows) return 100 + k;
        if (is_diagonal(A)) {          // row scaling
          for (int c = 0; c < n; ++c)
            for (int r = 0; r < m; ++r)
              C.buf[(size_t)c * m + r] =
                  A.buf[(size_t)r * m + r] * B.buf[(size_t)c * kk + r];
          break;
        }
        if (is_diagonal(B)) {          // column scaling
          for (int c = 0; c < n; ++c) {
            const cdouble d = B.buf[(size_t)c * kk + c];
            for (int r = 0; r < m; ++r)
              C.buf[(size_t)c * m + r] = A.buf[(size_t)c * m + r] * d;
          }
          break;
        }
        const cdouble one(1.0, 0.0), zero(0.0, 0.0);
        zgemm_("N", "N", &m, &n, &kk, &one, A.buf.data(), &m, B.buf.data(),
               &kk, &zero, C.buf.data(), &m);
        break;
      }
      case OP_ADD:
      case OP_SUB: {
        Slot& A = slots[I.a];
        Slot& B = slots[I.b];
        Slot& C = slots[I.out];
        const size_t n = A.buf.size();
        if (B.buf.size() != n) return 100 + k;
        if (I.op == OP_ADD)
          for (size_t i = 0; i < n; ++i) C.buf[i] = A.buf[i] + B.buf[i];
        else
          for (size_t i = 0; i < n; ++i) C.buf[i] = A.buf[i] - B.buf[i];
        break;
      }
      case OP_SCALE: {
        Slot& A = slots[I.a];
        Slot& C = slots[I.out];
        const cdouble alpha(pl[0], pl[1]);
        for (size_t i = 0; i < A.buf.size(); ++i) C.buf[i] = alpha * A.buf[i];
        break;
      }
      case OP_INV: {
        Slot& A = slots[I.a];
        Slot& C = slots[I.out];
        const int n = A.rows;
        if (is_diagonal(A)) {
          for (int i = 0; i < n; ++i) {
            const cdouble d = A.buf[(size_t)i * n + i];
            if (d == cdouble(0.0, 0.0)) return 202;
            C.buf[(size_t)i * n + i] = cdouble(1.0, 0.0) / d;
          }
          break;
        }
        C.buf = A.buf;
        std::vector<int> ipiv(n);
        int info = 0;
        zgetrf_(&n, &n, C.buf.data(), &n, ipiv.data(), &info);
        if (info != 0) return 200;
        const int lwork = n * 64;
        std::vector<cdouble> work(lwork);
        zgetri_(&n, C.buf.data(), &n, ipiv.data(), work.data(), &lwork,
                &info);
        if (info != 0) return 201;
        break;
      }
      case OP_KRONEYE: {
        Slot& A = slots[I.a];
        Slot& C = slots[I.out];
        const int nf = (int)I.b;
        for (int blk = 0; blk < nf; ++blk)
          for (int c = 0; c < A.cols; ++c)
            std::memcpy(&C.buf[(size_t)(blk * A.cols + c) * I.rows +
                               blk * A.rows],
                        &A.buf[(size_t)c * A.rows],
                        sizeof(cdouble) * A.rows);
        break;
      }
      case OP_BLOCK: {
        Slot& C = slots[I.out];
        const int n = (int)I.b;
        const int64_t n_blocks = I.plen / 3;
        for (int64_t e = 0; e < n_blocks; ++e) {
          const int bi = (int)pl[3 * e], bj = (int)pl[3 * e + 1];
          Slot& A = slots[(int)pl[3 * e + 2]];
          for (int c = 0; c < n; ++c)
            std::memcpy(&C.buf[(size_t)(bj * n + c) * I.rows + bi * n],
                        &A.buf[(size_t)c * n], sizeof(cdouble) * n);
        }
        break;
      }
      case OP_EIGMAX: {
        Slot& A = slots[I.a];
        const int n = A.rows;
        if (I.b == 1 && n >= 16) {
          // fast path: repeated squaring amplifies the dominant
          // eigenvalue, then the norm growth rate of a power iteration
          // gives rho.  Each squaring halves the relative error of the
          // final estimate; accurate to ~1e-4 relative even for complex
          // dominant pairs (growth oscillation averages out over the
          // window), which is far below fitness-relevant differences.
          const int n_square = 3;              // B = E^(2^3)
          std::vector<cdouble> B(A.buf), tmp((size_t)n * n);
          const cdouble one(1.0, 0.0), zero(0.0, 0.0);
          double log_scale = 0.0;              // log rho accumulated
          double weight = 1.0 / std::ldexp(1.0, n_square);
          for (int s = 0; s < n_square; ++s) {
            double nrm = 0.0;
            for (auto& v : B) nrm = std::max(nrm, std::abs(v));
            if (nrm == 0.0) { log_scale = -1e30; break; }
            const cdouble inv_nrm(1.0 / nrm, 0.0);
            for (auto& v : B) v *= inv_nrm;
            log_scale += std::log(nrm) * std::ldexp(1.0, n_square - s) *
                         weight;               // = log(nrm) / 2^s
            zgemm_("N", "N", &n, &n, &n, &one, B.data(), &n, B.data(), &n,
                   &zero, tmp.data(), &n);
            std::swap(B, tmp);
          }
          if (log_scale <= -1e29) break;       // zero propagator
          // power iteration on B with norm-growth estimate over a window
          std::vector<cdouble> x(n), y(n);
          unsigned seed = 12345u;
          for (int i = 0; i < n; ++i) {
            seed = seed * 1664525u + 1013904223u;
            x[i] = cdouble((seed >> 8) / double(1 << 24) - 0.5, 0.0);
          }
          const int warm = 10, window = 20;
          double log_growth = 0.0;
          const int ione_i = 1;
          for (int it = 0; it < warm + window; ++it) {
            zgemm_("N", "N", &n, &ione_i, &n, &one, B.data(), &n, x.data(),
                   &n, &zero, y.data(), &n);
            double nrm = 0.0;
            for (auto& v : y) nrm += std::norm(v);
            nrm = std::sqrt(nrm);
            if (nrm == 0.0) { log_growth = -1e30 * window; break; }
            const cdouble inv(1.0 / nrm, 0.0);
            for (int i = 0; i < n; ++i) x[i] = y[i] * inv;
            if (it >= warm) log_growth += std::log(nrm);
          }
          const double log_rho_B = log_growth / window;
          rho = std::max(rho, std::exp(log_rho_B * weight + log_scale));
          break;
        }
        std::vector<cdouble> a(A.buf);
        std::vector<cdouble> w(n);
        const int lwork = 4 * n;
        std::vector<cdouble> work(lwork);
        std::vector<double> rwork(2 * n);
        int info = 0;
        const int ione = 1;
        zgeev_("N", "N", &n, a.data(), &n, w.data(), nullptr, &ione,
               nullptr, &ione, work.data(), &lwork, rwork.data(), &info);
        if (info != 0) return 300;
        for (int i = 0; i < n; ++i) rho = std::max(rho, std::abs(w[i]));
        break;
      }
      default:
        return 400;
    }
    // free slots past their last use to bound per-thread memory
    if (I.op != OP_EIGMAX) {
      auto release = [&](int64_t s) {
        if (s >= 0 && s < n_slots && last_use[s] <= k) {
          slots[s].buf.clear();
          slots[s].buf.shrink_to_fit();
        }
      };
      release(I.a);
      release(I.b);
      if (I.op == OP_BLOCK) {
        for (int64_t e = 0; e < I.plen / 3; ++e)
          release((int64_t)pl[3 * e + 2]);
      }
    }
  }
  *rho_out = rho;
  return 0;
}

}  // namespace

extern "C" int lfa_execute(const double* thetas, int n_theta, int dim,
                           const int64_t* code_raw, int n_instr,
                           const double* payload, int n_slots, int n_threads,
                           double* out_rho) {
  const Instr* code = reinterpret_cast<const Instr*>(code_raw);

  // liveness: last instruction index that reads each slot
  std::vector<int> last_use(n_slots, -1);
  for (int k = 0; k < n_instr; ++k) {
    const Instr& I = code[k];
    auto touch = [&](int64_t s) {
      if (s >= 0 && s < n_slots) last_use[s] = k;
    };
    switch (I.op) {
      case OP_MATMUL: case OP_ADD: case OP_SUB:
        touch(I.a); touch(I.b); break;
      case OP_SCALE: case OP_INV: case OP_KRONEYE: case OP_EIGMAX:
        touch(I.a); break;
      case OP_BLOCK:
        for (int64_t e = 0; e < I.plen / 3; ++e)
          touch((int64_t)payload[I.poff + 3 * e + 2]);
        break;
      default:
        break;
    }
  }

  int status = 0;
  double rho = 0.0;
#if defined(_OPENMP)
  if (n_threads > 0) omp_set_num_threads(n_threads);
#pragma omp parallel for schedule(dynamic) reduction(max : rho)
#endif
  for (int t = 0; t < n_theta; ++t) {
    double r = 0.0;
    int st = run_theta(thetas + (size_t)t * dim, dim, code, n_instr, payload,
                       n_slots, last_use, &r);
    if (st != 0) {
#if defined(_OPENMP)
#pragma omp critical
#endif
      status = st;
    }
#if !defined(_OPENMP)
    rho = std::max(rho, r);
#else
    rho = std::max(rho, r);
#endif
  }
  *out_rho = rho;
  return status;
}
