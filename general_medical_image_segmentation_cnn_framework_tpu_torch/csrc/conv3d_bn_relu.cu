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
// elements. The 2-D convs of UNet2D (16 x 128^2, Cin 1 to 1024) are bound the same way:
// the 1 -> 64 stem by bytes (about 9 FLOPs per byte in bf16), every other conv by the
// math (from about 290 FLOPs per byte at 64 -> 64 up); the deep 8^2 and 16^2 grids
// (and UNet3D's 4^3 and 8^3) hold only 1,024-8,192 output voxels, too few 128-voxel
// tiles to fill 132 SMs, so there the reduction is split (see conv_wgmma).
//
// The launcher picks one of three variants from what it can see of the call:
//   bf16, Cin and Cout multiples of 8, 16-byte aligned pointers (every UNet3D and
//     UNet2D conv but the stem): conv_wgmma, wgmma m64nTNk16 from swizzled tiles that
//     one producer warpgroup fills through a 4-step mbarrier ring (hopper_gemm.cuh),
//     TN = 32, 64, 128 or 256 output channels per block; for the input gradient it
//     reads the forward's weights flipped and transposed, so that no copy is made;
//   other bf16 (the Cin = 1 stem): scalar gathers, WMMA (already faster than cuDNN);
//   f32: scalar gathers, register-tiled FMA (exact f32, no TF32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "hopper_gemm.cuh"

namespace {

constexpr int BM = 128;      // output voxels per block of the scalar-gather variants
constexpr int BN = 64;       // output channels per block
constexpr int BK = 32;       // reduction slice per step
constexpr int THREADS = 256;

struct Shape {
  long long m;  // N*D*H*W
  int d, h, w, cin, cout, k;  // k = KD*9*cin
  int relu;
  hopper::FastDiv fw, fh, fd;  // by w, h, d: voxel coordinates without divisions
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

// bf16 with Cin and Cout multiples of 8 (every UNet3D and UNet2D conv but the stem), on
// wgmma. A block owns BM = 128 output voxels by TN (32, 64, 128 or 256) output channels
// and one split [k_begin, k_end) of K = KD*9*Cin. Warpgroup 2 is the producer: for each
// step of BK = 64 K it gathers the A tile (K-major: 8 channels of one tap per 16-byte
// cp.async, zero-filled in the SAME padding) and copies the weight tile (MN-major:
// output channels contiguous) into a STAGES-deep ring of swizzled tiles; with FLIP (the
// input gradient) the weight tile is read K-major straight from the forward's weights,
// tap reversed and Cin/Cout swapped. The (d, h, w) of the block's 128 rows are decoded
// once per block into a bit mask of valid taps per row, so a copy tests one bit; the
// tap of a thread's chunk advances by 64 K per step without a division. The split plan
// (ops/conv3d_bn_relu.py conv_split_k) cuts K where the output tiles alone cannot fill
// the card (UNet3D's 4^3 and 8^3 convs, UNet2D's 8^2 to 32^2 ones). Warpgroups 0 and 1
// each multiply 64 of the rows (wgmma
// m64nTNk16, both operands from shared memory) as the slots fill, keeping one step's
// wgmma group in flight while they wait for the next slot. With one split the
// epilogue adds the bias, applies the ReLU and writes y in bf16; with several, each
// writes its f32 partial tile and finish_splits sums them in split order.
namespace wg {
constexpr int BK = 64, BM = 128, STAGES = 4;
constexpr int P = 128;  // producer threads: one warpgroup
template <int TN>
constexpr int smem_bytes() {
  return STAGES * (hopper::KTile<BM>::BYTES + hopper::MnTile<BK, TN>::BYTES) + 1024;
}
}  // namespace wg

// Bit tap ((dz*3+dy)*3+dx, dz only for KD = 3) of the mask is set iff the input voxel
// under that tap of output voxel (d, h, w) lies in the volume.
template <int KD>
__device__ __forceinline__ uint32_t tap_mask(const Shape& s, int d, int h, int w) {
  const uint32_t mx = 2u | (w > 0 ? 1u : 0u) | (w < s.w - 1 ? 4u : 0u);
  const uint32_t my = 2u | (h > 0 ? 1u : 0u) | (h < s.h - 1 ? 4u : 0u);
  const uint32_t plane = (my & 1u ? mx : 0u) | (my & 2u ? mx << 3 : 0u) | (my & 4u ? mx << 6 : 0u);
  if (KD == 1) return plane;
  const uint32_t mz = 2u | (d > 0 ? 1u : 0u) | (d < s.d - 1 ? 4u : 0u);
  return (mz & 1u ? plane : 0u) | (mz & 2u ? plane << 9 : 0u) | (mz & 4u ? plane << 18 : 0u);
}

template <int KD, int TN, bool FLIP>
__global__ void __launch_bounds__(256 + wg::P, 1)
conv_wgmma(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wt,
           const float* __restrict__ bias, __nv_bfloat16* __restrict__ y, float* __restrict__ part,
           Shape s, int kchunk) {
  using ATile = hopper::KTile<wg::BM>;       // [voxel][k]
  using BTile = hopper::MnTile<wg::BK, TN>;  // [k][output channel]
  using FTile = hopper::KTile<TN>;           // FLIP: [output channel][k], read from the forward's weights
  static_assert(BTile::BYTES == FTile::BYTES, "one stage layout for both weight tiles");
  constexpr int STAGE = ATile::BYTES + BTile::BYTES;
  extern __shared__ __align__(1024) unsigned char dyn[];
  __shared__ hopper::Ring<wg::STAGES> ring;
  __shared__ uint32_t rows_s[wg::BM];
  const uint32_t smem = (hopper::smem_u32(dyn) + 1023u) & ~1023u;
  const long long m0 = (long long)blockIdx.x * wg::BM;
  const int n0 = blockIdx.y * TN;
  const int k_begin = blockIdx.z * kchunk;
  const int k_end = min(k_begin + kchunk, s.k);
  const int nk = (k_end - k_begin + wg::BK - 1) / wg::BK;
  const int t = threadIdx.x % 128;
  constexpr int P = wg::P;
  if (threadIdx.x == 0) ring.init(8, P / 32);  // the consumer and producer warps
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producers: K-chunk c (channels 8c.. of the step) of rows r + (P/8)j; weight chunk
    // nc of K-rows kb + (P/BC)*i
    const int p = threadIdx.x - 256;
    const int c = p % 8, r = p / 8;
    constexpr int A_COPIES = wg::BM * 8 / P;
    if (p < wg::BM) {  // the valid taps of the block's rows, one decode per row
      if (m0 + p < s.m) {
        const uint32_t m = (uint32_t)(m0 + p), q = s.fw.div(m), q2 = s.fh.div(q);
        rows_s[p] = tap_mask<KD>(s, (int)(q2 - s.fd.div(q2) * s.d), (int)(q - q2 * s.h), (int)(m - q * s.w));
      } else {
        rows_s[p] = 0u;
      }
    }
    hopper::bar_sync(1, P);
    uint32_t rmask[A_COPIES];
#pragma unroll
    for (int j = 0; j < A_COPIES; ++j) rmask[j] = rows_s[r + (P / 8) * j];
    const __nv_bfloat16* xr = x + (m0 + r) * s.cin;
    constexpr int BC = TN / 8, B_COPIES = wg::BK * BC / P;
    const int nc = p % BC, kb = p / BC;
    const bool n_ok = n0 + 8 * nc < s.cout;
    const __nv_bfloat16* wb = wt + n0 + 8 * nc;
    int tap = (k_begin + 8 * c) / s.cin, ci = k_begin + 8 * c - tap * s.cin;  // 8 channels of one tap
    for (int it = 0; it < nk; ++it) {
      const int kstep = k_begin + it * wg::BK;
      const bool k_ok = kstep + 8 * c < k_end;
      const int dz = KD == 3 ? tap / 9 - 1 : 0, dy = (tap / 3) % 3 - 1, dx = tap % 3 - 1;
      const __nv_bfloat16* src = xr + (((long long)dz * s.h + dy) * s.w + dx) * s.cin + ci;
      ring.acquire(it);
      const uint32_t a_s = smem + (it % wg::STAGES) * STAGE, b_s = a_s + ATile::BYTES;
#pragma unroll
      for (int j = 0; j < A_COPIES; ++j) {
        const bool ok = k_ok && ((rmask[j] >> tap) & 1u);
        hopper::cp_async16(a_s + ATile::chunk(r + (P / 8) * j, c), ok ? src + (long long)((P / 8) * j) * s.cin : x,
                           ok);
      }
      if constexpr (FLIP) {
        // channels ci.. of the same tap as this thread's A chunk, for output channels
        // (the forward's input channels) r + (P/8)i: w[taps - 1 - tap][n][ci..]
        const __nv_bfloat16* wf = wt + ((long long)(KD * 9 - 1 - tap) * s.cout + n0 + r) * s.cin + ci;
#pragma unroll
        for (int i = 0; i < TN * 8 / P; ++i) {
          const int nr = r + (P / 8) * i;
          const bool ok = k_ok && n0 + nr < s.cout;
          hopper::cp_async16(b_s + FTile::chunk(nr, c), ok ? wf + (long long)((P / 8) * i) * s.cin : wt, ok);
        }
      } else {
#pragma unroll
        for (int i = 0; i < B_COPIES; ++i) {
          const int kr = kb + (P / BC) * i;
          const bool ok = n_ok && kstep + kr < k_end;
          hopper::cp_async16(b_s + BTile::chunk(kr, nc), ok ? wb + (long long)(kstep + kr) * s.cout : wt, ok);
        }
      }
      ring.commit(it);
      for (ci += wg::BK; ci >= s.cin; ci -= s.cin) ++tap;
    }
    ring.drain(nk);
  } else {
    const int wgi = threadIdx.x / 128;
    float acc[TN / 2];
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
    for (int it = 0; it < nk; ++it) {
      ring.consume(it);
      hopper::fence_proxy_async();
      const uint32_t a_s = smem + (it % wg::STAGES) * STAGE, b_s = a_s + ATile::BYTES;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < wg::BK / 16; ++kk)
        hopper::wgmma<TN, 0, FLIP ? 0 : 1>(acc, ATile::desc(a_s, kk, 64 * wgi),
                                           FLIP ? FTile::desc(b_s, kk, 0) : BTile::desc(b_s, kk, 0),
                                           (it == 0 && kk == 0) ? 0 : 1);
      hopper::wgmma_commit();
      if (it == nk - 1) {
        hopper::wgmma_wait<0>();
        hopper::fence_regs<TN / 2>(acc);
      } else {
        hopper::wgmma_wait<1>();  // the previous step's group is done: release its slot
      }
      if (it > 0) ring.release(it - 1);
    }
    float* out = part + (long long)blockIdx.z * s.m * s.cout;
#pragma unroll
    for (int i = 0; i < TN / 2; i += 2) {
      const long long m = m0 + 64 * wgi + hopper::acc_row(t, i);
      const int n = n0 + hopper::acc_col(t, i);
      if (m >= s.m || n >= s.cout) continue;
      if (part != nullptr) {
        *reinterpret_cast<float2*>(out + m * s.cout + n) = make_float2(acc[i], acc[i + 1]);
      } else {
        float v0 = acc[i], v1 = acc[i + 1];
        if (bias != nullptr) { v0 += bias[n]; v1 += bias[n + 1]; }
        if (s.relu) { v0 = fmaxf(v0, 0.f); v1 = fmaxf(v1, 0.f); }
        *reinterpret_cast<__nv_bfloat162*>(y + m * s.cout + n) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// y[i] = act(sum over splits z, in order, of part[z][i] + bias): deterministic.
__global__ void finish_splits(const float* __restrict__ part, const float* __restrict__ bias,
                              __nv_bfloat16* __restrict__ y, long long mn, int cout, int splits, int relu) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int z = 0; z < splits; ++z) acc += part[z * mn + i];
    if (bias != nullptr) acc += bias[i % cout];
    y[i] = __float2bfloat16(relu ? fmaxf(acc, 0.f) : acc);
  }
}

template <int KD, int TN, bool FLIP>
void launch_wgmma(const __nv_bfloat16* x, const __nv_bfloat16* wt, const float* bias, __nv_bfloat16* y,
                  float* part, const Shape& s, int kchunk, int splits, cudaStream_t st) {
  constexpr int bytes = wg::smem_bytes<TN>();
  static const cudaError_t attr =  // once per instantiation
      cudaFuncSetAttribute(conv_wgmma<KD, TN, FLIP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  (void)attr;
  const dim3 grid((unsigned)((s.m + wg::BM - 1) / wg::BM), (unsigned)((s.cout + TN - 1) / TN), (unsigned)splits);
  conv_wgmma<KD, TN, FLIP><<<grid, 256 + wg::P, bytes, st>>>(x, wt, bias, y, splits > 1 ? part : nullptr, s,
                                                            kchunk);
}

template <int KD, bool FLIP>
void launch_tiled(const __nv_bfloat16* x, const __nv_bfloat16* wt, const float* bias, __nv_bfloat16* y,
                  float* part, const Shape& s, int kchunk, int splits, cudaStream_t st) {
  if (s.cout <= 32)
    launch_wgmma<KD, 32, FLIP>(x, wt, bias, y, part, s, kchunk, splits, st);
  else if (s.cout <= 64)
    launch_wgmma<KD, 64, FLIP>(x, wt, bias, y, part, s, kchunk, splits, st);
  else if (s.cout <= 128)
    launch_wgmma<KD, 128, FLIP>(x, wt, bias, y, part, s, kchunk, splits, st);
  else
    launch_wgmma<KD, 256, FLIP>(x, wt, bias, y, part, s, kchunk, splits, st);
}

// Whether the call takes the wgmma variant (the only one that splits K).
bool tiled(const Shape& s, bool aligned16, int is_bf16) {
  return is_bf16 && s.cin % 8 == 0 && s.cout % 8 == 0 && aligned16;
}

template <int KD>
void launch(const void* x, const void* wt, const void* bias, void* y, void* part, const Shape& s, bool aligned16,
            int is_bf16, int flip, int kchunk, int splits, cudaStream_t st) {
  const unsigned m_tiles = (unsigned)((s.m + BM - 1) / BM);
  dim3 grid(m_tiles, (unsigned)((s.cout + BN - 1) / BN));
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(wt);
  const auto* bf = static_cast<const float*>(bias);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  auto* pf = static_cast<float*>(part);
  if (tiled(s, aligned16, is_bf16) && flip)
    launch_tiled<KD, true>(xb, wb, bf, yb, pf, s, kchunk, splits, st);
  else if (tiled(s, aligned16, is_bf16))
    launch_tiled<KD, false>(xb, wb, bf, yb, pf, s, kchunk, splits, st);
  else if (is_bf16)
    conv3d_bn_relu_bf16<KD><<<grid, THREADS, 0, st>>>(xb, wb, bf, yb, s);
  else
    conv3d_bn_relu_f32<KD><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(wt), bf, static_cast<float*>(y), s);
}

}  // namespace

// x [N,D,H,W,Cin], wt [kd*9*Cin, Cout] in x's dtype, bias [Cout] f32, y [N,D,H,W,Cout]
// in x's dtype; all contiguous on `device`. kd = 3 is the 3-D conv, kd = 1 the 2-D conv
// (D = 1); N*D*H*W < 2^31. With flip = 1 (the input gradient, wgmma variant only), wt
// is instead the forward conv's weight [kd*9, Cout, Cin] (the conv whose input gradient
// this is maps Cout channels to Cin) and is read flipped and transposed; bias may be
// null (no bias). The wgmma variant splits K in `splits` ranges of `kchunk` (a multiple
// of 64) and then needs part, f32 [splits, N*D*H*W, Cout]; every other variant takes
// splits = 1. Launches on `stream` without synchronising and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a kd or a split plan or flip the call
// cannot take.
extern "C" int conv3d_bn_relu_launch(const void* x, const void* wt, const void* bias, void* y, void* part,
                                     long long n, int d, int h, int w, int cin, int cout, int kd,
                                     int relu, int flip, int is_bf16, int kchunk, int splits, int device,
                                     void* stream) {
  if ((kd != 1 && kd != 3) || n * d * h * w >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  Shape s;
  s.m = n * d * h * w;
  s.d = d; s.h = h; s.w = w; s.cin = cin; s.cout = cout; s.k = kd * 9 * cin;
  s.relu = relu;
  s.fw = hopper::FastDiv((uint32_t)w);
  s.fh = hopper::FastDiv((uint32_t)h);
  s.fd = hopper::FastDiv((uint32_t)d);
  const bool aligned16 = ((reinterpret_cast<unsigned long long>(x) |
                           reinterpret_cast<unsigned long long>(wt) |
                           reinterpret_cast<unsigned long long>(y)) & 15) == 0;
  const bool wgmma = tiled(s, aligned16, is_bf16);
  if (splits < 1 || kchunk <= 0 || kchunk % 64 != 0 || (long long)kchunk * (splits - 1) >= s.k ||
      (long long)kchunk * splits < s.k || (splits > 1 && (part == nullptr || !wgmma)) || (flip && !wgmma) ||
      (bias == nullptr && !wgmma))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kd == 3)
    launch<3>(x, wt, bias, y, part, s, aligned16, is_bf16, flip, kchunk, splits, st);
  else
    launch<1>(x, wt, bias, y, part, s, aligned16, is_bf16, flip, kchunk, splits, st);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long mn = s.m * cout;
  const int blocks = (int)((mn + 255) / 256 < 8192 ? (mn + 255) / 256 : 8192);
  finish_splits<<<blocks, 256, 0, st>>>(static_cast<const float*>(part), static_cast<const float*>(bias),
                                        static_cast<__nv_bfloat16*>(y), mn, cout, splits, relu);
  return (int)cudaGetLastError();
}
