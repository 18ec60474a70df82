// Fused k3 s1 SAME Conv3d / Conv2d + folded BatchNorm + ReLU for Hopper (sm_90a).
//
// y[n,d,h,w,o] = relu(sum_{dz,dy,dx,c} x[n,d+dz-1,h+dy-1,w+dx-1,c] * wt[dz,dy,dx,c,o] + b[o])
// on NDHWC tensors, with BatchNorm already folded into wt and b by the caller. KD, a
// template parameter, is the number of depth taps: 3 for the 3-D conv, 1 for the 2-D
// conv, whose NHWC input is launched as NDHWC with D = 1 and whose weight is
// [3,3,Cin,Cout] (dz = 0 only: no depth tap is gathered and then wasted on padding).
//
// Replaces four TPU kernels of the JAX package that compute this one function:
//   ops/pallas_conv.py    fused_conv3d_bn_relu     (_conv_block_kernel)            KD = 3
//   ops/pallas_tlayout.py conv2d_tapcols_tlayout   (_kernel; eval forward of conv3d_tlayout)
//   ops/pallas_tlayout.py conv3d_tlayout_fused     (_kernel_fused)                 KD = 3
//   ops/pallas_tlayout.py conv2d_plane_tlayout     (_kernel with kd = 1: the 2-D conv
//                         and, on flipped transposed weights, its input gradient)  KD = 1
// Their T-layout, lane folding, pad-to-128, Cin pad to 32 and VMEM budgeting only fit
// the TPU's tiling and are not carried over.
//
// Formulation: an implicit GEMM, C[M, Cout] = A[M, KD*9*Cin] x B[KD*9*Cin, Cout], with
// M = N*D*H*W output voxels and k = tap*Cin + c (tap = (dz*3+dy)*3+dx, dz only for
// KD = 3). A is never materialised: each block gathers its A tile straight from the
// NDHWC input, and the SAME zero padding is a bounds check on (d, h, w), not a padded
// copy. B is the weight tensor as it lies in memory, [KD,3,3,Cin,Cout] ==
// [KD*9*Cin, Cout]. f32 accumulation, bias + ReLU in the epilogue, one write of y in
// x's dtype.
//
// What bounds it on an H100: moving each input and output voxel once, the stem
// (Cin = 1, Cout = 32, bf16) does about 26 FLOPs per byte of HBM traffic, under the
// card's bf16 ridge of about 295, so it is bound by bytes; from Cin = Cout = 32 up it
// does 400 or more and is bound by the math. The design: the A tile is gathered once
// per block and reused by all of the tile's output channels, the weight tile by all
// BM voxels, and the 27 taps re-read each input voxel from L2, not HBM. Ragged M, K
// and Cout edges are zero-filled on load and masked on store, so any Cin and Cout
// work. All element offsets are 64-bit: a 16 x 128^3 x 64 activation has 2.1e9
// elements. No TMA or wgmma yet. The 2-D convs of UNet2D (16 x 128^2, Cin 1 to 1024)
// are bound the same way: the 1 -> 64 stem by bytes (about 9 FLOPs per byte in bf16),
// every other conv by the math (from about 290 FLOPs per byte at 64 -> 64 up); the deep
// 8^2 and 16^2 grids hold only 1,024-4,096 output voxels, 8-32 row tiles, so few blocks.
//
// The launcher picks one of three variants from what it can see of the call:
//   bf16, Cin and Cout multiples of 8, 16-byte aligned pointers (every UNet3D and
//     UNet2D conv but the stem): 16-byte cp.async copies into a 3-deep ring of tiles, so copies
//     overlap the tensor-core math (WMMA 16x16x16, f32 accumulation); tiles 32
//     channels wide at Cout <= 32, else 64;
//   other bf16 (the Cin = 1 stem): scalar gathers, WMMA;
//   f32: scalar gathers, register-tiled FMA (exact f32, no TF32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

constexpr int BM = 128;      // output voxels per block
constexpr int BN = 64;       // output channels per block
constexpr int BK = 32;       // reduction slice per step
constexpr int THREADS = 256;

struct Shape {
  long long m;  // N*D*H*W
  int d, h, w, cin, cout, k;  // k = KD*9*cin
  int relu;
};

// (d, h, w) of the block's BM output rows; rows past M get a depth that fails
// every bounds check, so they gather zeros and are never stored.
__device__ __forceinline__ void load_rows(const Shape& s, long long m0, int* rd, int* rh, int* rw) {
  for (int r = threadIdx.x; r < BM; r += THREADS) {
    long long m = m0 + r;
    if (m < s.m) {
      long long q = m;
      rw[r] = (int)(q % s.w); q /= s.w;
      rh[r] = (int)(q % s.h); q /= s.h;
      rd[r] = (int)(q % s.d);
    } else {
      rd[r] = -4; rh[r] = 0; rw[r] = 0;
    }
  }
}

// The gather of this thread's A column k for one K step: tap offsets and channel.
struct Tap {
  bool ok;
  int dz, dy, dx, c;
  long long delta;  // voxel offset of the tap
};

template <int KD>
__device__ __forceinline__ Tap tap_of(const Shape& s, int k) {
  Tap t;
  t.ok = k < s.k;
  int tap = t.ok ? k / s.cin : 0;
  t.c = k - tap * s.cin;
  t.dz = KD == 3 ? tap / 9 - 1 : 0;
  t.dy = (tap / 3) % 3 - 1;
  t.dx = tap % 3 - 1;
  t.delta = ((long long)t.dz * s.h + t.dy) * s.w + t.dx;
  return t;
}

// A[m, k] for this thread's tap, or 0 where the tap falls in the SAME padding.
template <typename T>
__device__ __forceinline__ T gather(const T* __restrict__ x, const Shape& s, const Tap& t,
                                    long long m, int rd, int rh, int rw, T zero) {
  int d = rd + t.dz, h = rh + t.dy, w = rw + t.dx;
  if (t.ok && (unsigned)d < (unsigned)s.d && (unsigned)h < (unsigned)s.h &&
      (unsigned)w < (unsigned)s.w)
    return x[(m + t.delta) * s.cin + t.c];
  return zero;
}

// f32: shared-memory tiles and an 8 x 4 register micro-tile per thread.
template <int KD>
__global__ void __launch_bounds__(THREADS)
conv3d_bn_relu_f32(const float* __restrict__ x, const float* __restrict__ wt,
                   const float* __restrict__ bias, float* __restrict__ y, Shape s) {
  __shared__ float As[BK][BM + 1];  // [k][m]; +1 keeps the column writes conflict-free
  __shared__ float Bs[BK][BN];      // [k][n]
  __shared__ int rd[BM], rh[BM], rw[BM];

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  load_rows(s, m0, rd, rh, rw);

  const int tx = tid % 16, ty = tid / 16;  // compute: cols tx + 16j, rows ty + 16i
  const int a_k = tid % BK, a_r = tid / BK;  // A loads: column a_k, rows a_r + 8i
  const int b_n = tid % BN, b_k = tid / BN;  // B loads: column b_n, rows b_k + 4i

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  __syncthreads();

  for (int k0 = 0; k0 < s.k; k0 += BK) {
    const Tap t = tap_of<KD>(s, k0 + a_k);
#pragma unroll
    for (int i = 0; i < BM / 8; ++i) {
      int r = a_r + 8 * i;
      As[a_k][r] = gather(x, s, t, m0 + r, rd[r], rh[r], rw[r], 0.f);
    }
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      int kk = b_k + 4 * i, kg = k0 + kk, n = n0 + b_n;
      Bs[kk][b_n] = (kg < s.k && n < s.cout) ? wt[(long long)kg * s.cout + n] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    long long m = m0 + ty + 16 * i;
    if (m >= s.m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int n = n0 + tx + 16 * j;
      if (n >= s.cout) continue;
      float v = acc[i][j] + bias[n];
      if (s.relu) v = fmaxf(v, 0.f);
      y[m * s.cout + n] = v;
    }
  }
}

// bf16: the same tiles in bf16, multiplied on the tensor cores. 8 warps as 4 (M) x 2
// (N), each owning a 32 x 32 piece of the 128 x 64 tile as 2 x 2 WMMA fragments.
constexpr int LDA = BK + 8;  // bf16 row pitches: multiples of 8, rows 32-byte aligned
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;  // f32 pitch of the epilogue tile
constexpr int AB_BYTES = (BM * LDA + BK * LDB) * 2;
constexpr int C_BYTES = BM * LDC * 4;
constexpr int SMEM_BYTES = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;

template <int KD>
__global__ void __launch_bounds__(THREADS)
conv3d_bn_relu_bf16(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wt,
                    const float* __restrict__ bias, __nv_bfloat16* __restrict__ y, Shape s) {
  using namespace nvcuda;
  // The A/B tiles of the K loop and the f32 epilogue tile share one buffer.
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __shared__ int rd[BM], rh[BM], rw[BM];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [BM][LDA] (m, k)
  __nv_bfloat16* Bs = As + BM * LDA;                             // [BK][LDB] (k, n)
  float* Cs = reinterpret_cast<float*>(smem);                    // [BM][LDC]

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  load_rows(s, m0, rd, rh, rw);

  const int warp = tid / 32, wm = warp % 4, wn = warp / 4;
  const int a_k = tid % BK, a_r = tid / BK;
  const int b_n = tid % BN, b_k = tid / BN;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  __syncthreads();

  for (int k0 = 0; k0 < s.k; k0 += BK) {
    const Tap t = tap_of<KD>(s, k0 + a_k);
#pragma unroll
    for (int i = 0; i < BM / 8; ++i) {
      int r = a_r + 8 * i;
      As[r * LDA + a_k] = gather(x, s, t, m0 + r, rd[r], rh[r], rw[r], zero);
    }
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      int kk = b_k + 4 * i, kg = k0 + kk, n = n0 + b_n;
      Bs[kk * LDB + b_n] = (kg < s.k && n < s.cout) ? wt[(long long)kg * s.cout + n] : zero;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * LDA + ks, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + ks * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();

  const int n = n0 + tid % BN;
  if (n < s.cout) {
    const float bn = bias[n];
    for (int r = tid / BN; r < BM; r += THREADS / BN) {
      long long m = m0 + r;
      if (m >= s.m) break;
      float v = Cs[r * LDC + tid % BN] + bn;
      if (s.relu) v = fmaxf(v, 0.f);
      y[m * s.cout + n] = __float2bfloat16(v);
    }
  }
}

// bf16 with Cin and Cout multiples of 8 (every UNet3D conv but the Cin = 1 stem):
// 16-byte cp.async copies of 8 channels at a time, with the SAME padding as the
// copy's zero-fill, into a STAGES-deep ring of A/B tiles, so the copies of the next
// tiles overlap the tensor-core work on the current one. Warps own 32 x 32 pieces as
// above, 4 along M and WARPS_N along N; the tile is TN = 32 * WARPS_N channels wide.
// TN = 32 serves Cout <= 32, where a 64-wide tile would multiply zeros in half its
// fragments (the largest convs of UNet3D, at full resolution, have Cout = 32). The
// epilogue writes 8 channels per 16-byte store.
constexpr int STAGES = 3;
constexpr int A_STAGE = BM * LDA;  // bf16 elements per stage

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  int n = valid ? 16 : 0;  // 0: read nothing, fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int KD, int WARPS_N>
__global__ void __launch_bounds__(128 * WARPS_N)
conv3d_bn_relu_bf16_async(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ wt, const float* __restrict__ bias,
                          __nv_bfloat16* __restrict__ y, Shape s) {
  using namespace nvcuda;
  constexpr int NT = 128 * WARPS_N;  // threads
  constexpr int TN = 32 * WARPS_N;   // tile width in output channels
  constexpr int LDB_ = TN + 8, LDC_ = TN + 4;
  constexpr int B_STAGE = BK * LDB_;
  constexpr int PIPE_BYTES = STAGES * (A_STAGE + B_STAGE) * 2;
  constexpr int EPI_BYTES = BM * LDC_ * 4;
  constexpr int A_COPIES = BM * (BK / 8) / NT;  // 16-byte A copies per thread per stage
  static_assert(BK * (TN / 8) == NT, "one 16-byte B copy per thread per stage");
  __shared__ __align__(128) unsigned char smem[PIPE_BYTES > EPI_BYTES ? PIPE_BYTES : EPI_BYTES];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [STAGES][BM][LDA]
  __nv_bfloat16* Bs = As + STAGES * A_STAGE;                     // [STAGES][BK][LDB_]
  float* Cs = reinterpret_cast<float*>(smem);                    // [BM][LDC_], after the loop

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * TN;
  const int warp = tid / 32, wm = warp % 4, wn = warp / 4;
  // A copies: channels a_c*8.. of rows a_r + (NT/4)*j; B copies: row b_k, 8 columns
  const int a_c = tid % 4, a_r = tid / 4;
  const int b_k = tid / (TN / 8), b_c = tid % (TN / 8);
  int rd[A_COPIES], rh[A_COPIES], rw[A_COPIES];
#pragma unroll
  for (int j = 0; j < A_COPIES; ++j) {
    long long m = m0 + a_r + (NT / 4) * j;
    if (m < s.m) {
      rw[j] = (int)(m % s.w); m /= s.w;
      rh[j] = (int)(m % s.h); m /= s.h;
      rd[j] = (int)(m % s.d);
    } else {
      rd[j] = -4; rh[j] = 0; rw[j] = 0;  // fails every bounds check
    }
  }

  auto load_stage = [&](int kt, int slot) {
    const int k0 = kt * BK;
    const Tap t = tap_of<KD>(s, k0 + a_c * 8);  // 8 channels of one tap: Cin % 8 == 0
    __nv_bfloat16* a_dst = As + slot * A_STAGE + a_c * 8;
#pragma unroll
    for (int j = 0; j < A_COPIES; ++j) {
      int r = a_r + (NT / 4) * j;
      int d = rd[j] + t.dz, h = rh[j] + t.dy, w = rw[j] + t.dx;
      bool ok = t.ok && (unsigned)d < (unsigned)s.d && (unsigned)h < (unsigned)s.h &&
                (unsigned)w < (unsigned)s.w;
      cp_async16(a_dst + r * LDA, ok ? x + (m0 + r + t.delta) * s.cin + t.c : x, ok);
    }
    int kg = k0 + b_k, n = n0 + b_c * 8;
    bool ok = kg < s.k && n < s.cout;
    cp_async16(Bs + slot * B_STAGE + b_k * LDB_ + b_c * 8,
               ok ? wt + (long long)kg * s.cout + n : wt, ok);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = (s.k + BK - 1) / BK;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load_stage(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // tile kt has landed
    __syncthreads();              // ... for every thread, and slot (kt-1) % STAGES is free
    if (kt + STAGES - 1 < nk) load_stage(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();
    const __nv_bfloat16* a_s = As + (kt % STAGES) * A_STAGE;
    const __nv_bfloat16* b_s = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], a_s + (wm * 32 + i * 16) * LDA + ks, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], b_s + ks * LDB_ + wn * 32 + j * 16, LDB_);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC_ + wn * 32 + j * 16, acc[i][j], LDC_,
                              wmma::mem_row_major);
  __syncthreads();

  for (int i = tid; i < BM * (TN / 8); i += NT) {
    const int r = i / (TN / 8), c = (i % (TN / 8)) * 8;
    const long long m = m0 + r;
    const int n = n0 + c;
    if (m >= s.m || n >= s.cout) continue;
    __nv_bfloat162 out[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v0 = Cs[r * LDC_ + c + 2 * e] + bias[n + 2 * e];
      float v1 = Cs[r * LDC_ + c + 2 * e + 1] + bias[n + 2 * e + 1];
      if (s.relu) { v0 = fmaxf(v0, 0.f); v1 = fmaxf(v1, 0.f); }
      out[e] = __floats2bfloat162_rn(v0, v1);
    }
    *reinterpret_cast<uint4*>(y + m * s.cout + n) = *reinterpret_cast<const uint4*>(out);
  }
}

template <int KD>
void launch(const void* x, const void* wt, const void* bias, void* y, const Shape& s, bool aligned16,
            int is_bf16, cudaStream_t st) {
  const unsigned m_tiles = (unsigned)((s.m + BM - 1) / BM);
  dim3 grid(m_tiles, (unsigned)((s.cout + BN - 1) / BN));
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(wt);
  const auto* bf = static_cast<const float*>(bias);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  const bool async = is_bf16 && s.cin % 8 == 0 && s.cout % 8 == 0 && aligned16;
  if (async && s.cout <= 32)
    conv3d_bn_relu_bf16_async<KD, 1><<<dim3(m_tiles, 1), 128, 0, st>>>(xb, wb, bf, yb, s);
  else if (async)
    conv3d_bn_relu_bf16_async<KD, 2><<<grid, 256, 0, st>>>(xb, wb, bf, yb, s);
  else if (is_bf16)
    conv3d_bn_relu_bf16<KD><<<grid, THREADS, 0, st>>>(xb, wb, bf, yb, s);
  else
    conv3d_bn_relu_f32<KD><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(wt),
        static_cast<const float*>(bias), static_cast<float*>(y), s);
}

}  // namespace

// x [N,D,H,W,Cin], wt [kd*9*Cin, Cout] in x's dtype, bias [Cout] f32, y [N,D,H,W,Cout]
// in x's dtype; all contiguous on `device`. kd = 3 is the 3-D conv, kd = 1 the 2-D conv
// (D = 1). Launches on `stream` without synchronising and returns cudaGetLastError(),
// or cudaErrorInvalidValue for another kd.
extern "C" int conv3d_bn_relu_launch(const void* x, const void* wt, const void* bias, void* y,
                                     long long n, int d, int h, int w, int cin, int cout,
                                     int kd, int relu, int is_bf16, int device, void* stream) {
  if (kd != 1 && kd != 3) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Shape s;
  s.m = n * d * h * w;
  s.d = d; s.h = h; s.w = w; s.cin = cin; s.cout = cout; s.k = kd * 9 * cin;
  s.relu = relu;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned16 = ((reinterpret_cast<unsigned long long>(x) |
                           reinterpret_cast<unsigned long long>(wt) |
                           reinterpret_cast<unsigned long long>(y)) & 15) == 0;
  if (kd == 3)
    launch<3>(x, wt, bias, y, s, aligned16, is_bf16, st);
  else
    launch<1>(x, wt, bias, y, s, aligned16, is_bf16, st);
  return (int)cudaGetLastError();
}
