// Extremes of the spectra of a batch of symmetric float64 Grams, for Hopper
// (sm_90a): for each Gram, max|w| and min|w| over its eigenvalues w.
//
// Replaces no TPU kernel. The condition-number backfill
// (driver.host_condition_numbers) reads those two numbers of every agent's
// float64 Gram at every z row. The JAX package computes them on the host's
// LAPACK (a TPU emulates float64); torch.linalg.eigvalsh on the card loops
// cuSOLVER's syevd over the batch one Gram at a time for n > 32, ~2.2 ms a
// Gram of 238-260 rows on an H100. This kernel takes a backfill chunk's Grams,
// every agent's at its own size n, in one launch.
//
// What bounds it: neither operations nor bytes. A Gram of n rows is ~4n^3/3
// operations (0.25 ms of the card's 34 TFLOP/s FP64 for 64 Grams of 250 rows)
// and n^2 doubles read once. Its reduction to tridiagonal form is n - 1
// dependent Householder steps, each a symmetric matrix-vector product, a dot
// product and a rank-2 update that the next step waits for: latency bounds
// it, the barriers of each step and the shared-memory round trips between
// them. On an H100 a step of a north-star Gram (clusters of 2) takes ~9 us,
// ~1.5 us of it a cluster barrier: 64 Grams of 238-260 rows in ~2.6 ms.
//
// Design: one thread-block cluster a Gram, of C = 1, 2, 4 or 8 blocks: the
// smallest whose shared memory holds the launch's largest Gram
// (ops/cuda_eig.py::cluster_size mirrors `layout` below). The Gram's lower
// triangle stays in the cluster's shared memory for the whole reduction, row
// i in block i mod C, packed (row i holds columns 0..i), so no step touches
// device memory. Step k (LAPACK's dsytd2, lower):
//   1. every warp of every block reads x = A[k+1:, k], which each block holds
//      whole, and forms the reflector (beta, tau, v = x / (alpha - beta),
//      v_0 = 1) itself: the same arithmetic on the same bits in the same
//      order everywhere, so no barrier is needed;
//   2. p = tau A v over the trailing matrix: each block adds its own rows'
//      row parts (a warp a row) and their transposes' column parts (a thread
//      a column, the rows split over thread groups), then pushes its partial
//      p into every block through distributed shared memory; cluster barrier;
//   3. each block sums the C partials, every warp forms K = -tau/2 (p . v),
//      and each block applies A -= v w^T + w v^T (w = p + K v) to its own
//      rows, pushing the updated column k + 1 into every block (x is
//      double-buffered by the step's parity); cluster barrier.
// The diagonal d and off-diagonal e (e_k = beta) collect in block 0. Block 0
// then finds the tridiagonal's wanted eigenvalues by Sturm counts (LAPACK's
// dlaebz recurrence, with dstebz's pivmin and widened Gershgorin bounds): with
// c the count below 0, the smallest (index 1), the largest (n), and the two
// around zero (c and c + 1). One warp an eigenvalue multisects its interval at
// 32 shifts a round, spread evenly over the interval's doubles (their bit
// patterns) rather than its length, so each eigenvalue is found to the last
// bit the count resolves, in at most 13 rounds whatever its magnitude. It
// writes max(|w_1|, |w_n|) and the least |w| of w_c and w_{c+1}.
//
// A Gram with a non-finite entry gives NaN for both numbers; the backfill then
// raises, as eigvalsh does on such Grams.
//
// Interface: plain C, loaded with ctypes. The launch runs on the caller's
// stream, allocates nothing, and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTargets = 4;     // eigenvalues wanted: indices 1, n, c, c + 1
constexpr int kShifts = 32;     // a warp's lanes: shifts a multisection round
constexpr int kMaxRounds = 16;  // 33^13 > 2^63 keys; a guard for non-finite input

// Rank r's local row l is row i = r + l C, holding columns 0..i.
__host__ __device__ inline int row_offset(int l, int r, int C) {
  return l * (r + 1) + C * l * (l - 1) / 2;
}

__host__ __device__ inline int own_rows(int n, int r, int C) {
  return r < n ? (n - r + C - 1) / C : 0;
}

// The shared-memory layout of a launch, in doubles (ops/cuda_eig.py::smem_words).
struct Layout {
  long long a, x, slots, p, colp, rowp, d, e, flags, res, words;
};

__host__ __device__ inline Layout layout(int nmax, int C) {
  Layout L;
  long long rows = 0;
  for (int r = 0; r < C; ++r) {
    const long long w = row_offset(own_rows(nmax, r, C), r, C);
    rows = w > rows ? w : rows;
  }
  const int pad = (nmax + 31) & ~31;
  long long o = 0;
  L.a = o;     o += rows;                        // the own rows, packed
  L.x = o;     o += 2LL * nmax;                  // column k, by the step's parity
  L.slots = o; o += (long long)C * nmax;         // each rank's partial p
  L.p = o;     o += nmax;                        // p
  L.colp = o;  o += pad > kThreads ? pad : kThreads;  // column parts by thread group
  L.rowp = o;  o += (nmax + C - 1) / C;          // row parts by own row
  L.d = o;     o += nmax;
  L.e = o;     o += nmax;
  L.flags = o; o += 8;                           // a rank's non-finite flag
  L.res = o;   o += kTargets;                    // the wanted eigenvalues
  L.words = o;
  return L;
}

// Every lane gets the same bits: a + b == b + a at each butterfly stage.
__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ double warp_min(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmin(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ double warp_max(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmax(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Eigenvalues of the tridiagonal (d, e^2) below sigma (dlaebz's count).
__device__ int sturm_count(const double* d, const double* e2, int n, double sigma,
                           double pivmin) {
  double q = d[0] - sigma;
  if (fabs(q) < pivmin) q = -pivmin;
  int count = q <= 0.0;
  for (int j = 1; j < n; ++j) {
    q = d[j] - e2[j - 1] / q - sigma;
    if (fabs(q) < pivmin) q = -pivmin;
    count += q <= 0.0;
  }
  return count;
}

// A double's place among the doubles, as an integer that orders as they do.
__device__ __forceinline__ long long to_key(double x) {
  const long long b = __double_as_longlong(x);
  return b >= 0 ? b : -(b & 0x7fffffffffffffffLL);
}

__device__ __forceinline__ double from_key(long long k) {
  return k >= 0 ? __longlong_as_double(k) : -__longlong_as_double(-k);
}

// The k-th smallest eigenvalue (1-based) in [a, b], an interval of one sign
// with count(a) < k <= count(b), by one warp.
__device__ double kth_eigenvalue(const double* d, const double* e2, int n, double pivmin,
                                 int k, double a, double b, int lane) {
  long long lo = to_key(a), hi = to_key(b);
  for (int round = 0; round < kMaxRounds && hi - lo > 1; ++round) {
    const unsigned long long span = (unsigned long long)(hi - lo);
    const unsigned long long q = span / (kShifts + 1), rem = span % (kShifts + 1);
    const long long key =
        lo + (long long)(q * (lane + 1) + rem * (lane + 1) / (kShifts + 1));
    const unsigned mask =
        __ballot_sync(0xffffffffu, sturm_count(d, e2, n, from_key(key), pivmin) >= k);
    const int first = mask ? __ffs(mask) - 1 : kShifts;  // warp-uniform
    const long long below = __shfl_sync(0xffffffffu, key, (first + kShifts - 1) % kShifts);
    const long long above = __shfl_sync(0xffffffffu, key, first % kShifts);
    if (first > 0) lo = below;
    if (first < kShifts) hi = above;
  }
  return 0.5 * (from_key(lo) + from_key(hi));
}

// table: (G, 2) int64, a Gram's address (a contiguous row-major n x n
// float64 matrix) and n; out: (G, 2) float64, max|w| and min|w|. Cluster g
// takes Gram g.
__global__ void __launch_bounds__(kThreads, 1)
gram_extremes_kernel(const long long* __restrict__ table, double* __restrict__ out,
                     int nmax, int C) {
  extern __shared__ double smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank();
  const int g = blockIdx.x / C;
  const int n = (int)table[2 * g + 1];
  const double* __restrict__ gram = reinterpret_cast<const double*>(table[2 * g]);
  const Layout L = layout(nmax, C);
  double* A = smem + L.a;
  double* X = smem + L.x;
  double* slots = smem + L.slots;
  double* p = smem + L.p;
  double* colp = smem + L.colp;
  double* rowp = smem + L.rowp;
  double* d = smem + L.d;
  double* e = smem + L.e;
  double* flags = smem + L.flags;
  double* res = smem + L.res;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nrows = own_rows(n, r, C);

  auto remote = [&](double* ptr, int q) -> double* {
    return C == 1 ? ptr : cluster.map_shared_rank(ptr, q);
  };
  auto barrier = [&]() {
    if (C == 1) __syncthreads(); else cluster.sync();
  };

  barrier();  // every block of the cluster runs before any writes into another

  // The own rows' lower triangle; column 0 into every block.
  bool finite = true;
  for (int l = warp; l < nrows; l += kWarps) {
    const int i = r + l * C;
    double* row = A + row_offset(l, r, C);
    for (int j = lane; j <= i; j += 32) {
      const double a = gram[(long long)i * n + j];
      finite = finite && isfinite(a);
      row[j] = a;
      if (j == 0)
        for (int q = 0; q < C; ++q) remote(X, q)[i] = a;
    }
  }
  finite = __syncthreads_and(finite);
  if (threadIdx.x == 0)
    for (int q = 0; q < C; ++q) remote(flags, q)[r] = finite ? 0.0 : 1.0;
  barrier();
  bool bad = false;
  for (int q = 0; q < C; ++q) bad = bad || flags[q] != 0.0;

  for (int k = 0; !bad && k + 1 < n; ++k) {
    const double* xk = X + (k & 1) * nmax;       // column k, rows k..n-1
    double* xn = X + ((k + 1) & 1) * nmax;       // column k + 1, pushed below
    const int m = n - 1 - k;                     // the trailing matrix's size
    double s = 0.0;
    for (int i = k + 2 + lane; i < n; i += 32) s += xk[i] * xk[i];
    s = warp_sum(s);
    const double alpha = xk[k + 1];
    double tau = 0.0, beta = alpha, scale = 0.0;
    if (s > 0.0) {
      beta = -copysign(sqrt(alpha * alpha + s), alpha);
      tau = (beta - alpha) / beta;
      scale = 1.0 / (alpha - beta);
    }
    if (r == 0 && threadIdx.x == 0) {
      d[k] = xk[k];
      e[k] = beta;
    }
    auto v = [&](int j) { return j == k + 1 ? 1.0 : xk[j] * scale; };
    const int l0 = k + 1 > r ? (k + 1 - r + C - 1) / C : 0;  // the first own row > k
    if (tau != 0.0) {
      // 2. this block's partial p: the own rows' row parts ...
      for (int l = l0 + warp; l < nrows; l += kWarps) {
        const int i = r + l * C;
        const double* row = A + row_offset(l, r, C);
        double acc = 0.0;
#pragma unroll 4
        for (int j = k + 1 + lane; j <= i; j += 32) acc += row[j] * v(j);
        acc = warp_sum(acc);
        if (lane == 0) rowp[l] = acc;
      }
      // ... and the column parts of their entries left of the diagonal,
      // column j = k + 1 + t by thread t of each of S groups of rows
      const int pad = (m + 31) & ~31;
      const int S = pad <= kThreads ? kThreads / pad : 1;
      for (int u = threadIdx.x; u < S * pad; u += kThreads) {
        const int seg = u / pad, t = u - seg * pad, j = k + 1 + t;
        const int jw = k + 1 + (t & ~31);  // the warp's first column
        int l = jw >= r ? (jw - r) / C + 1 : 0;  // the first own row below it
        l += ((seg - l) % S + S) % S;
        double acc = 0.0;
#pragma unroll 4
        for (; l < nrows; l += S) {
          const int i = r + l * C;
          if (t < m && i > j) acc += A[row_offset(l, r, C) + j] * (xk[i] * scale);
        }
        if (t < m) colp[seg * pad + t] = acc;
      }
      __syncthreads();
      for (int t = threadIdx.x; t < m; t += kThreads) {
        const int j = k + 1 + t;
        double pp = 0.0;
        for (int seg = 0; seg < S; ++seg) pp += colp[seg * pad + t];
        if (j >= r && (j - r) % C == 0) pp += rowp[(j - r) / C];
        pp *= tau;
        for (int q = 0; q < C; ++q) remote(slots, q)[r * nmax + t] = pp;
      }
      barrier();
      // 3. p, K, and the rank-2 update of the own rows
      for (int t = threadIdx.x; t < m; t += kThreads) {
        double pt = 0.0;
        for (int q = 0; q < C; ++q) pt += slots[q * nmax + t];
        p[t] = pt;
      }
      __syncthreads();
      double kk = 0.0;
      for (int t = lane; t < m; t += 32) kk += p[t] * v(k + 1 + t);
      kk = -0.5 * tau * warp_sum(kk);
      for (int l = l0 + warp; l < nrows; l += kWarps) {
        const int i = r + l * C;
        double* row = A + row_offset(l, r, C);
        const double vi = v(i), wi = p[i - k - 1] + kk * vi;
#pragma unroll 4
        for (int j = k + 1 + lane; j <= i; j += 32) {
          const double vj = v(j);
          const double a = row[j] - (vi * (p[j - k - 1] + kk * vj) + wi * vj);
          row[j] = a;
          if (j == k + 1)
            for (int q = 0; q < C; ++q) remote(xn, q)[i] = a;
        }
      }
    } else if (lane == 0) {  // the identity reflector: column k + 1 as it is
      for (int l = l0 + warp; l < nrows; l += kWarps) {
        const int i = r + l * C;
        const double a = A[row_offset(l, r, C) + k + 1];
        for (int q = 0; q < C; ++q) remote(xn, q)[i] = a;
      }
    }
    barrier();
  }
  if (r != 0) return;  // no block reads another's memory after the last barrier

  // Block 0: the tridiagonal's extremes.
  if (threadIdx.x == 0) d[n - 1] = X[((n - 1) & 1) * nmax + n - 1];
  double* e2 = colp;
  for (int j = threadIdx.x; j + 1 < n; j += kThreads) e2[j] = e[j] * e[j];
  __syncthreads();
  if (bad) {
    if (threadIdx.x == 0) out[2 * g] = out[2 * g + 1] = __longlong_as_double(0x7ff8000000000000LL);
    return;
  }
  if (warp < kTargets) {
    double lo = DBL_MAX, hi = -DBL_MAX, emax2 = 0.0;
    for (int j = lane; j < n; j += 32) {
      const double off = (j > 0 ? fabs(e[j - 1]) : 0.0) + (j + 1 < n ? fabs(e[j]) : 0.0);
      lo = fmin(lo, d[j] - off);
      hi = fmax(hi, d[j] + off);
      if (j + 1 < n) emax2 = fmax(emax2, e2[j]);
    }
    lo = warp_min(lo);
    hi = warp_max(hi);
    const double pivmin = DBL_MIN * fmax(1.0, warp_max(emax2));
    const double widen = 2.1 * fmax(fabs(lo), fabs(hi)) * DBL_EPSILON * n + 4.2 * pivmin;
    lo -= widen;
    hi += widen;
    const int c = sturm_count(d, e2, n, 0.0, pivmin);
    const int k = warp == 0 ? 1 : warp == 1 ? n : warp == 2 ? c : c + 1;
    double w = __longlong_as_double(0x7ff8000000000000LL);  // NaN: not wanted
    if (k >= 1 && k <= n)
      w = k <= c ? kth_eigenvalue(d, e2, n, pivmin, k, fmin(lo, 0.0), 0.0, lane)
                 : kth_eigenvalue(d, e2, n, pivmin, k, 0.0, fmax(hi, 0.0), lane);
    if (lane == 0) res[warp] = w;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    out[2 * g] = fmax(fabs(res[0]), fabs(res[1]));
    out[2 * g + 1] = fmin(fabs(res[2]), fabs(res[3]));  // fmin passes over the NaN
  }
}

}  // namespace

extern "C" {

const char* dqgp_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Dynamic shared memory a block takes for a launch whose largest Gram has
// nmax rows, in clusters of C blocks.
long long dqgp_gram_extremes_smem_bytes(int nmax, int C) {
  return layout(nmax, C).words * (long long)sizeof(double);
}

// table points at a (G, 2) int64 tensor [address, n] and out at a (G, 2)
// float64 tensor; nmax is the largest n, C the cluster size (1, 2, 4 or 8).
// Returns cudaGetLastError().
int dqgp_gram_extremes(const long long* table, double* out, int grams, int nmax, int C,
                       long long smem_bytes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      gram_extremes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grams * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gram_extremes_kernel, table, out, nmax, C);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Clusters of C blocks the card holds at once at this shared memory (-1 on error).
int dqgp_gram_extremes_max_clusters(int C, long long smem_bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      gram_extremes_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err != cudaSuccess) return -1;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, gram_extremes_kernel, &cfg) != cudaSuccess)
    return -1;
  return clusters;
}

}  // extern "C"
