// The streamed gradient's contraction of one parameter, for Hopper (sm_90a):
// from every agent's features at the +h and -h shifts straight to
//
//   g_p = 1/2 sum_ij bracket[j, i] * m_i m_j * f64((K+[i, j] - K-[i, j]) / 2h),
//
// K+- the projected kernel's Matern Gram of the shifted features. The Gram
// pair is never stored.
//
// Replaces no TPU kernel. The JAX package's streamed gradient
// (dqgp_tpu/parallel/consensus.py) and the port's PyTorch loop
// (parallel/consensus.py::streamed_nll_and_grad) materialise the pair,
// (A, 2, N, N) float32, and pass it through about eighteen elementwise
// passes and a product: ~13.9 GB of traffic a parameter at config #7's
// shapes (64 agents of 717-844 rows), ~4.6 ms on an H100.
//
// What bounds it: the bracket, (A, N, N) float64, read once (313 MB of real
// rows at config #7, ~0.09 ms at 3.35 TB/s), against ~2 D + 25 float32
// operations an entry and sign (~0.05 ms at 67 TFLOP/s over the lower
// triangle). Both are near; the design keeps the two in flight together.
//
// Design: a persistent grid, three blocks an SM, walks the work items
// (agent, I, J), I >= J, the lower triangle of 64 x 64 tiles of every
// agent's Gram. A block stages the tile pair's rows of both sides and both
// signs in shared memory with asynchronous copies (all in flight at once),
// row-major at a stride of 4 x odd floats (a float4 read of eight lanes'
// rows meets no bank twice), and row r of a tile at position
// (r & 1) * 32 + (r >> 1), so that a thread's rows 2t, 2t + 1, 2t + 32,
// 2t + 33 sit at positions t + 16 m. Each of the 256 threads holds a 4 x 4
// block of entries: the dot products in registers over float4 chunks, then
// the Matern closed form, then (K+ - K-) / 2h. Its bracket entries are pairs
// of adjacent columns, read a 2 x 2 quadrant at a time as 16-byte loads that
// evict first: bracket[i, j] along the rows, and off the diagonal
// bracket[j, i] too, since the kernel computes the dot product the same way
// for (i, j) and (j, i) and dK is exactly symmetric, so an off-diagonal tile
// carries the weight bracket[i, j] + bracket[j, i]. Each item's sum is a
// float64 block reduction in a fixed order into its own slot; a second
// kernel sums an agent's slots in a fixed order and writes 1/2 of it into
// column p of the gradient. No float atomics: reruns give identical bits.
// What holds it back on an H100 is latency: ~0.42 ms a parameter at config
// #7, ~23 % of the byte bound, with 3 blocks an SM (0.50 with 2).
//
// Numerics: the float32 arithmetic is the PyTorch path's step for step on
// the card, each operation rounded on its own (__f*_rn, never contracted):
// sqdist = (|F_i|^2 + |F_j|^2) - 2 <F_i, F_j>, clamped at 0 (NaN stays
// NaN, as torch.clamp keeps it), + 1e-30, sqrtf, times 1/ls (PyTorch
// divides a CUDA tensor by a host scalar as a multiply by its float
// reciprocal), the closed forms of models/kernels/outer.py for nu = 0.5,
// 1.5, 2.5 and inf with expf, then (K+ - K-) times the float reciprocal of
// 2h, and the upcast. The sums too follow the card's PyTorch path: a row's
// squared norm as torch.sum(F * F, -1) reduces a row of D < 64 floats (the
// products rounded; lane x of the largest power of 2 <= D adds x and
// x + width, then the lanes shuffle down at width / 2, ..., 2, 1), and each
// dot product over k in order with fmaf, as a SIMT float32 gemm accumulates
// it. That matters: the Matern of nearly equal rows reads sqdist, a
// difference of numbers ~2n, near 0, and norms summed in another order moved
// g_p by ~1e-1 of its largest component at config #7. So only the float64
// sums' order differs.
// Entries whose mask product is 0 are skipped; a NaN or inf in a real row
// reaches g_p.
//
// Interface: plain C, loaded with ctypes. The launch runs on the caller's
// stream, allocates nothing (the caller passes one float64 slot an item,
// dqgp_shift_pair_contract_slots an agent), and returns cudaGetLastError().

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;                 // rows of a tile's side
constexpr int kThreads = 256;             // 16 x 16 threads, 4 x 4 entries each
constexpr int kWarps = kThreads / 32;
constexpr int kArrays = 4;                // i side +h, i side -h, j side +h, j side -h
constexpr int kMaxD = 63;                 // a row's norm within one warp, as PyTorch sums it
constexpr int kSumThreads = 32;
// Blocks an SM: the kernel waits on latency, and three (80 registers, a
// 32-byte stack frame) ran 17-20 % faster on an H100 than two without a spill.
constexpr int kMinBlocks = 3;

// The float constants as PyTorch rounds its host scalars to float.
constexpr float kSqrt3 = (float)1.7320508075688772;  // math.sqrt(3.0)
constexpr float kSqrt5 = (float)2.23606797749979;    // math.sqrt(5.0)
constexpr float kThird = 1.0f / 3.0f;                // k * k / 3.0 as a multiply

struct Args {
  const float* F;       // (A, 2, nmax, D): [:, 0] at +h, [:, 1] at -h
  const double* B;      // (A, nmax, nmax)
  const double* mask;   // (A, nmax)
  double* slots;        // (A * items,)
  int A, nmax, D, chunks, stride, items;
  int width;            // lanes a row's norm: the largest power of 2 <= D (D < 64)
  float inv_2h, inv_ls;
  int vec;              // 16-byte bracket loads (nmax even, base aligned)
};

// Floats a staged row takes: 4 x an odd number, at least 4 x chunks.
__host__ __device__ inline int row_stride(int chunks) { return 4 * (chunks | 1); }

__host__ __device__ inline long long smem_bytes(int chunks) {
  return 2LL * kTile * 8 + kWarps * 8                    // the mask by side, warp sums
         + (long long)kArrays * kTile * row_stride(chunks) * 4  // the staged rows
         + kArrays * kTile * 4;                          // their squared norms
}

// A tile's row r sits at position (r & 1) * 32 + (r >> 1); position p holds row:
__device__ __forceinline__ int row_of(int p) { return 2 * (p & 31) + (p >> 5); }

template <int kNu>
__device__ __forceinline__ float matern(float sq_i, float sq_j, float dot, float inv_ls) {
  float d2 = __fsub_rn(__fadd_rn(sq_i, sq_j), __fmul_rn(2.0f, dot));
  d2 = d2 < 0.0f ? 0.0f : d2;
  const float d = __fmul_rn(__fsqrt_rn(__fadd_rn(d2, 1e-30f)), inv_ls);
  if (kNu == 0) return expf(-d);
  if (kNu == 1) {
    const float k = __fmul_rn(d, kSqrt3);
    return __fmul_rn(__fadd_rn(1.0f, k), expf(-k));
  }
  if (kNu == 2) {
    const float k = __fmul_rn(d, kSqrt5);
    const float t = __fadd_rn(__fadd_rn(1.0f, k), __fmul_rn(__fmul_rn(k, k), kThird));
    return __fmul_rn(t, expf(-k));
  }
  return expf(__fmul_rn(__fmul_rn(-0.5f, d), d));
}

// bracket[row, col] and bracket[row, col + 1] (col even); 0 outside the array.
__device__ __forceinline__ double2 load_pair(const double* B, int row, int col, int nmax,
                                             int vec) {
  double2 v = make_double2(0.0, 0.0);
  if (row >= nmax) return v;
  const double* p = B + (size_t)row * nmax + col;
  if (vec && col + 1 < nmax) return __ldcs(reinterpret_cast<const double2*>(p));
  if (col < nmax) v.x = __ldcs(p);
  if (col + 1 < nmax) v.y = __ldcs(p + 1);
  return v;
}

template <int kNu>
__global__ void __launch_bounds__(kThreads, kMinBlocks) shift_pair_contract_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* ms = reinterpret_cast<double*>(smem);         // [2][64] by position
  double* wsum = ms + 2 * kTile;                         // [kWarps]
  float* fs = reinterpret_cast<float*>(wsum + kWarps);   // [4][64][stride]
  float* sq = fs + kArrays * kTile * a.stride;           // [4][64]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int s4 = a.stride / 4;
  const int total = a.A * a.items;

  for (int item = blockIdx.x; item < total; item += gridDim.x) {
    const int agent = item / a.items;
    const int t = item - agent * a.items;
    int I = (int)((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);  // t = I (I + 1) / 2 + J
    while (I * (I + 1) / 2 > t) --I;
    while ((I + 1) * (I + 2) / 2 <= t) ++I;
    const int J = t - I * (I + 1) / 2;
    const int r0i = I * kTile, r0j = J * kTile;

    __syncthreads();  // the previous item is done with shared memory
    if (tid < 2 * kTile) {
      const int r = (tid < kTile ? r0i : r0j) + row_of(tid & (kTile - 1));
      ms[tid] = r < a.nmax ? a.mask[(size_t)agent * a.nmax + r] : 0.0;
    }
    // each thread tests the slot it wrote; the barriers publish all of them
    const int live_i = __syncthreads_or(tid < kTile && ms[tid] != 0.0);
    const int live_j = __syncthreads_or(tid >= kTile && tid < 2 * kTile && ms[tid] != 0.0);
    if (!live_i || !live_j) {  // a side of padded rows only
      if (tid == 0) a.slots[item] = 0.0;
      continue;
    }

    // a warp a row, its lanes the row's floats; zeros past D and past nmax
    for (int arr = 0; arr < kArrays; ++arr) {
      const int r0 = arr < 2 ? r0i : r0j;
      const float* src = a.F + (size_t)(agent * 2 + (arr & 1)) * a.nmax * a.D;
      float* dst = fs + arr * kTile * a.stride;
      for (int r = warp; r < kTile; r += kWarps) {
        const int row = r0 + r;
        float* drow = dst + ((r & 1) * 32 + (r >> 1)) * a.stride;
        for (int k = lane; k < 4 * a.chunks; k += 32) {
          if (row < a.nmax && k < a.D)
            __pipeline_memcpy_async(drow + k, src + (size_t)row * a.D + k, sizeof(float));
          else
            drow[k] = 0.0f;
        }
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    // squared norms, sq[arr * 64 + position], as torch.sum(F * F, -1) sums a
    // row of D < 64 floats on the card: the products rounded, lane x of
    // `width` adds x and x + width, then shuffles down at width / 2, ..., 1
    for (int r = (warp * 32 + lane) / a.width; r < kArrays * kTile;
         r += kThreads / a.width) {
      const int x = lane % a.width;
      const float* row = fs + r * a.stride;
      float s = __fmul_rn(row[x], row[x]);
      if (x + a.width < a.D) s = __fadd_rn(s, __fmul_rn(row[x + a.width], row[x + a.width]));
      for (int o = a.width >> 1; o > 0; o >>= 1)
        s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, o));
      if (x == 0) sq[r] = s;
    }
    __syncthreads();

    // dK of the thread's entries: rows at positions ty + 16 m, columns tx + 16 m
    float dk[4][4];
#pragma unroll
    for (int sign = 0; sign < 2; ++sign) {
      const float4* fi = reinterpret_cast<const float4*>(fs + sign * kTile * a.stride);
      const float4* fj = reinterpret_cast<const float4*>(fs + (2 + sign) * kTile * a.stride);
      float acc[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int mj = 0; mj < 4; ++mj) acc[mi][mj] = 0.0f;
#pragma unroll 2
      for (int q = 0; q < a.chunks; ++q) {
        float4 x[4], y[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          x[m] = fi[(ty + 16 * m) * s4 + q];
          y[m] = fj[(tx + 16 * m) * s4 + q];
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int mj = 0; mj < 4; ++mj) {
            float c = acc[mi][mj];
            c = fmaf(x[mi].x, y[mj].x, c);
            c = fmaf(x[mi].y, y[mj].y, c);
            c = fmaf(x[mi].z, y[mj].z, c);
            c = fmaf(x[mi].w, y[mj].w, c);
            acc[mi][mj] = c;
          }
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int mj = 0; mj < 4; ++mj) {
          const float k = matern<kNu>(sq[sign * kTile + ty + 16 * mi],
                                      sq[(2 + sign) * kTile + tx + 16 * mj], acc[mi][mj],
                                      a.inv_ls);
          dk[mi][mj] = sign == 0 ? k : __fmul_rn(__fsub_rn(dk[mi][mj], k), a.inv_2h);
        }
    }

    // the bracket by quadrant (hi, hj): entry m of a side is row
    // 2 t + 32 (m & 1) + (m >> 1), so a pair of columns at 2 t + 32 h holds
    // the entries m = h and h + 2
    const double* B = a.B + (size_t)agent * a.nmax * a.nmax;
    double sum = 0.0;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
#pragma unroll
      for (int hj = 0; hj < 2; ++hj) {
        const int ri = r0i + 2 * ty + 32 * hi, rj = r0j + 2 * tx + 32 * hj;
        const double2 d0 = load_pair(B, ri, rj, a.nmax, a.vec);
        const double2 d1 = load_pair(B, ri + 1, rj, a.nmax, a.vec);
        double w[2][2] = {{d0.x, d0.y}, {d1.x, d1.y}};  // [mi = hi, hi + 2][mj = hj, hj + 2]
        if (I != J) {
          const double2 t0 = load_pair(B, rj, ri, a.nmax, a.vec);
          const double2 t1 = load_pair(B, rj + 1, ri, a.nmax, a.vec);
          w[0][0] = __dadd_rn(w[0][0], t0.x);
          w[1][0] = __dadd_rn(w[1][0], t0.y);
          w[0][1] = __dadd_rn(w[0][1], t1.x);
          w[1][1] = __dadd_rn(w[1][1], t1.y);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int v = 0; v < 2; ++v) {
            const int mi = hi + 2 * u, mj = hj + 2 * v;
            const double m = __dmul_rn(ms[ty + 16 * mi], ms[kTile + tx + 16 * mj]);
            if (m != 0.0)
              sum = __dadd_rn(sum, __dmul_rn(w[u][v], __dmul_rn((double)dk[mi][mj], m)));
          }
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, o);
    if (lane == 0) wsum[warp] = sum;
    __syncthreads();
    if (tid == 0) {
      double s = 0.0;
      for (int k = 0; k < kWarps; ++k) s += wsum[k];
      a.slots[item] = s;
    }
  }
}

// out[agent * stride] = 1/2 the sum of the agent's slots, in a fixed order.
__global__ void __launch_bounds__(kSumThreads) pair_contract_sum_kernel(
    const double* slots, int items, double* out, long long stride) {
  const double* s = slots + (size_t)blockIdx.x * items;
  double v = 0.0;
  for (int k = threadIdx.x; k < items; k += kSumThreads) v += s[k];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if (threadIdx.x == 0) out[blockIdx.x * stride] = 0.5 * v;
}

typedef void (*KernelFn)(Args);

KernelFn kernel_for(int nu) {
  switch (nu) {
    case 0: return shift_pair_contract_kernel<0>;
    case 1: return shift_pair_contract_kernel<1>;
    case 2: return shift_pair_contract_kernel<2>;
    case 3: return shift_pair_contract_kernel<3>;
    default: return nullptr;
  }
}

int chunks_of(int D) { return (D + 3) / 4; }

// Work items an agent: the lower triangle of its Gram's 64-row tiles.
int items_of(int nmax) {
  const int tiles = (nmax + kTile - 1) / kTile;
  return tiles * (tiles + 1) / 2;
}

// Resident blocks of the persistent grid, by device, nu code and D: 0 until
// the first launch there sets the kernel's shared-memory limit and asks the
// occupancy, the SM count and the device once (a streamed step calls the
// launch P times; a CUDA graph captures it after an eager warm-up).
constexpr int kMaxDevices = 64;
int g_grid[kMaxDevices][4][kMaxD + 1];

}  // namespace

extern "C" {

const char* dqgp_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

long long dqgp_shift_pair_contract_smem_bytes(int D) { return smem_bytes(chunks_of(D)); }

// The widest feature row the kernel takes.
int dqgp_shift_pair_contract_max_d() { return kMaxD; }

// Float64 slots an agent of nmax rows takes: one a work item.
int dqgp_shift_pair_contract_slots(int nmax) { return items_of(nmax); }

// Blocks an SM holds at once for features of width D, nu code 0-3 (0.5,
// 1.5, 2.5, inf); 0 where the launch would be refused. It lets the kernel
// take the shared memory of the widest D, so that a launch at any D after
// this call finds the limit high enough (the launch asks once a D).
int dqgp_shift_pair_contract_blocks_per_sm(int D, int nu) {
  KernelFn fn = kernel_for(nu);
  if (fn == nullptr || D < 1 || D > kMaxD) return 0;
  const int bytes = (int)smem_bytes(chunks_of(D));
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_bytes(chunks_of(kMaxD))) != cudaSuccess)
    return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kThreads, bytes) != cudaSuccess)
    return 0;
  return n;
}

// F (A, 2, nmax, D) float32, B (A, nmax, nmax) and mask (A, nmax) float64,
// all contiguous; slots holds A * dqgp_shift_pair_contract_slots(nmax)
// doubles; out[a * out_stride] gets
// agent a's g_p. two_h and length_scale are the host's doubles, rounded to
// float and inverted in float as PyTorch does; nu is the code of
// dqgp_shift_pair_contract_blocks_per_sm.
int dqgp_shift_pair_contract(const float* F, const double* B, const double* mask,
                             double* slots, double* out, int A, int nmax, int D,
                             long long out_stride, double two_h, double length_scale, int nu,
                             void* stream) {
  KernelFn fn = kernel_for(nu);
  if (fn == nullptr || D < 1 || D > kMaxD || A < 1 || nmax < 1)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.F = F;
  a.B = B;
  a.mask = mask;
  a.slots = slots;
  a.A = A;
  a.nmax = nmax;
  a.D = D;
  a.chunks = chunks_of(D);
  a.stride = row_stride(a.chunks);
  a.items = items_of(nmax);
  a.width = 1;
  while (2 * a.width <= D) a.width *= 2;
  a.inv_2h = 1.0f / (float)two_h;
  a.inv_ls = 1.0f / (float)length_scale;
  a.vec = (nmax % 2 == 0) && ((uintptr_t)B % 16 == 0);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  int& resident = g_grid[device][nu][D];
  if (resident == 0) {
    const int per_sm = dqgp_shift_pair_contract_blocks_per_sm(D, nu);
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    resident = per_sm * sms;
  }
  const long long total = (long long)A * a.items;
  const int grid = (int)(total < resident ? total : resident);
  cudaStream_t s = (cudaStream_t)stream;
  fn<<<grid, kThreads, smem_bytes(a.chunks), s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  pair_contract_sum_kernel<<<A, kSumThreads, 0, s>>>(slots, a.items, out, out_stride);
  return (int)cudaGetLastError();
}

}  // extern "C"
