// Weight gradient of the k3 s1 SAME Conv3d / Conv2d for Hopper (sm_90a).
//
// dw[dz,dy,dx,ci,co] = sum_{n,d,h,w} x[n,d+dz-1,h+dy-1,w+dx-1,ci] * g[n,d,h,w,co]
// on NDHWC tensors x [N,D,H,W,Cin] and g [N,D,H,W,Cout] (the cotangent of the conv's
// output), with the SAME zero padding; dw is f32 [KD,3,3,Cin,Cout]. KD, a template
// parameter, is the number of depth taps: 3 for the 3-D conv, 1 for the 2-D conv, whose
// NHWC tensors are launched with D = 1 (dz = 0 only).
//
// Replaces the TPU kernel of the JAX package that computes this function:
//   ops/pallas_tlayout.py wgrad_tapcols_tlayout (_wgrad_kernel)                 KD = 3
// and, with KD = 1, the 2-D conv's weight gradient, which the JAX package leaves to
// XLA (ops/pallas_tlayout.py _wgrad2d_tlayout, in the VJP of conv2d_plane_tlayout).
// The T-layout im2col rebuild and the grid-resident accumulator (the TPU grid runs
// in order, so one VMEM block sums over the whole grid) are not carried over.
//
// Formulation: a GEMM, dw[M, Cout] = A[M, V] x g[V, Cout], with M = KD*9*Cin rows
// (m = tap*Cin + ci, tap = (dz*3+dy)*3+dx: the layout of dw in memory) and the
// reduction over the V = N*D*H*W voxels of g. A[m, v] is the x voxel under tap m of
// output voxel v, gathered on the fly; a tap in the SAME padding reads as zero by a
// bounds check, not a padded copy. f32 accumulation.
//
// What bounds it on an H100: M*Cout is small (864 x 32 at the full-resolution convs of
// UNet3D) while V reaches 4.2 M voxels at batch 16 x 64^3, so the reduction has to be
// split. Blocks own an output tile AND a chunk of voxels (split-K): each writes its
// partial tile to a workspace [splits, M, Cout], and a second pass sums the partials in
// split order, so the result is the same on every run (no float atomics). With each of x
// and g read once it does about 27*Cin*Cout*2/(2*(Cin+Cout)) FLOPs per byte in bf16:
// 432 at Cin = Cout = 32, over the card's bf16 ridge of about 295, so it is bound by the
// math from 32 channels up and by bytes below. All element offsets are 64-bit; voxel
// coordinates are decoded in 32 bits, so V must stay below 2^31 (the launcher checks).
// UNet2D (16 x 128^2) has the other extreme: V = 4,096 voxels at the 16^2 grid against
// M = 9*1024 = 9,216 rows (72 x 4 output tiles, so the sizing splits it only in two), and
// the stem's M = 9 rows, which leave 119 of the FMA tile's 128 rows empty (its useful
// work is 0.3 GFLOP).
//
// The launcher picks one of two variants from what it can see of the call:
//   bf16, Cin and Cout multiples of 8, 16-byte aligned pointers (every UNet3D and
//     UNet2D conv but the stem): 16-byte cp.async copies of 8 channels into a 3-deep ring of tiles,
//     tensor cores (WMMA 16x16x16, f32 accumulation), tiles 32 or 64 channels wide;
//   other bf16 (the Cin = 1 stem) and f32: scalar loads into f32 tiles and a
//     register-tiled FMA (exact f32, no TF32).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

constexpr int BM = 128;  // rows of dw (tap, ci) per block
constexpr int BK = 32;   // voxels per reduction step

struct WShape {
  int v;                    // voxels N*D*H*W
  int d, h, w, cin, cout;
  int m;                    // KD*9*cin
  int chunk;                // voxels per split, a multiple of BK
};

// The tap of dw row m, its channel and its voxel offset; ok is false past M.
struct Row {
  bool ok;
  int dz, dy, dx, c;
  long long delta;
};

template <int KD>
__device__ __forceinline__ Row row_of(const WShape& s, int m) {
  Row r;
  r.ok = m < s.m;
  int tap = r.ok ? m / s.cin : 0;
  r.c = m - tap * s.cin;
  r.dz = KD == 3 ? tap / 9 - 1 : 0;
  r.dy = (tap / 3) % 3 - 1;
  r.dx = tap % 3 - 1;
  r.delta = ((long long)r.dz * s.h + r.dy) * s.w + r.dx;
  return r;
}

// (d, h, w) of voxel v, and the same coordinates advanced by `step` voxels (cheaper
// than decoding anew: voxels are visited in order).
struct Vox {
  int d, h, w;
};

__device__ __forceinline__ Vox decode(const WShape& s, int v) {
  unsigned q = (unsigned)v;
  Vox c;
  c.w = (int)(q % (unsigned)s.w); q /= (unsigned)s.w;
  c.h = (int)(q % (unsigned)s.h); q /= (unsigned)s.h;
  c.d = (int)(q % (unsigned)s.d);
  return c;
}

__device__ __forceinline__ void advance(const WShape& s, Vox& c, int step) {
  c.w += step;
  while (c.w >= s.w) {
    c.w -= s.w;
    if (++c.h == s.h) {
      c.h = 0;
      if (++c.d == s.d) c.d = 0;
    }
  }
}

// Whether the x voxel under row r's tap of the output voxel at c lies in the volume.
__device__ __forceinline__ bool tap_inside(const WShape& s, const Row& r, Vox c) {
  int d = c.d + r.dz, h = c.h + r.dy, w = c.w + r.dx;
  return (unsigned)d < (unsigned)s.d && (unsigned)h < (unsigned)s.h && (unsigned)w < (unsigned)s.w;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// f32 and ragged bf16: f32 shared tiles, an 8 x 4 register micro-tile per thread,
// 256 threads over a 128 (rows) x 64 (Cout) tile. The partial tile of split z goes to
// part[z] (part == dw when there is one split).
constexpr int FBN = 64;
constexpr int FTHREADS = 256;

template <int KD, typename T>
__global__ void __launch_bounds__(FTHREADS)
wgrad_fma(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ part, WShape s) {
  __shared__ float As[BK][BM];   // [voxel][row]
  __shared__ float Bs[BK][FBN];  // [voxel][cout]
  __shared__ Vox vox[BK];        // coordinates of the step's voxels, decoded once
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * FBN;
  const int v_begin = blockIdx.z * s.chunk;
  const int v_end = min(v_begin + s.chunk, s.v);

  const int a_m = tid % BM, a_k = tid / BM;   // A loads: row a_m, voxels a_k + 2i
  const int b_n = tid % FBN, b_k = tid / FBN; // B loads: column b_n, voxels b_k + 4i
  const int tx = tid % 16, ty = tid / 16;     // compute: cols tx + 16j, rows ty + 16i
  const Row r = row_of<KD>(s, m0 + a_m);
  const bool b_ok = n0 + b_n < s.cout;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int v0 = v_begin; v0 < v_end; v0 += BK) {
    if (tid < BK) vox[tid] = decode(s, min(v0 + tid, s.v - 1));
    __syncthreads();
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      int k = a_k + 2 * i, v = v0 + k;
      float a = 0.f;
      if (r.ok && v < v_end && tap_inside(s, r, vox[k]))
        a = to_f32(x[((long long)v + r.delta) * s.cin + r.c]);
      As[k][a_m] = a;
    }
#pragma unroll
    for (int i = 0; i < BK / 4; ++i) {
      int k = b_k + 4 * i, v = v0 + k;
      Bs[k][b_n] = (b_ok && v < v_end) ? to_f32(g[(long long)v * s.cout + n0 + b_n]) : 0.f;
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

  float* out = part + (long long)blockIdx.z * s.m * s.cout;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int m = m0 + ty + 16 * i;
    if (m >= s.m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int n = n0 + tx + 16 * j;
      if (n < s.cout) out[(long long)m * s.cout + n] = acc[i][j];
    }
  }
}

// bf16 with Cin and Cout multiples of 8: 16-byte cp.async copies into a STAGES-deep
// ring, so the copies of the next voxel steps overlap the tensor-core work on the
// current one. The A tile is stored voxel-major ([BK][BM]: 8 channels of one tap are
// 16 contiguous bytes in x and in the tile) and read as a column-major WMMA operand.
// Warps own 32 x 32 pieces as 2 x 2 fragments, 4 along the rows and WARPS_N along
// Cout; the tile is TN = 32 * WARPS_N channels wide (32 serves Cout <= 32).
// The tensor cores add into their f32 accumulator without rounding to nearest, an
// error that grows with the accumulator's magnitude and, over the ~10^5 voxels of a
// split, reached 1e-4 of the result (measured on the H100 against an f64 sum). So
// each voxel step's products are summed in a fresh fragment and then added, rounded
// to nearest, into f32 registers that hold the split's total.
constexpr int STAGES = 3;
constexpr int LDA = BM + 8;        // bf16 pitch of an A row (one voxel): 272 bytes
constexpr int A_STAGE = BK * LDA;  // bf16 elements per stage

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  int n = valid ? 16 : 0;  // 0: read nothing, fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int KD, int WARPS_N>
__global__ void __launch_bounds__(128 * WARPS_N)
wgrad_bf16_async(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                 float* __restrict__ part, WShape s) {
  using namespace nvcuda;
  constexpr int NT = 128 * WARPS_N;
  constexpr int TN = 32 * WARPS_N;
  constexpr int LDB = TN + 8, LDC = TN + 4;
  constexpr int B_STAGE = BK * LDB;
  constexpr int PIPE_BYTES = STAGES * (A_STAGE + B_STAGE) * 2;
  constexpr int EPI_BYTES = BM * LDC * 4;
  constexpr int A_COPIES = BK * (BM / 8) / NT;  // 16-byte A copies per thread per stage
  static_assert(BK * (TN / 8) == NT, "one 16-byte B copy per thread per stage");
  __shared__ __align__(128) unsigned char smem[PIPE_BYTES > EPI_BYTES ? PIPE_BYTES : EPI_BYTES];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [STAGES][BK][LDA] (v, m)
  __nv_bfloat16* Bs = As + STAGES * A_STAGE;                     // [STAGES][BK][LDB] (v, n)
  float* Cs = reinterpret_cast<float*>(smem);                    // [BM][LDC], after the loop

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * TN;
  const int v_begin = blockIdx.z * s.chunk;
  const int v_end = min(v_begin + s.chunk, s.v);
  const int warp = tid / 32, wm = warp % 4, wn = warp / 4;
  // A copies: rows a_c*8.. (8 channels of one tap: Cin % 8 == 0) of voxels
  // a_k + (NT/16)*j; B copies: voxel b_k, 8 channels from b_c*8
  const int a_c = tid % (BM / 8), a_k = tid / (BM / 8);
  const int b_k = tid / (TN / 8), b_c = tid % (TN / 8);
  const Row r = row_of<KD>(s, m0 + a_c * 8);
  const bool b_ok = n0 + b_c * 8 < s.cout;
  // coordinates of this thread's A-copy voxels for the next stage to load; stages
  // are loaded in order, so each load advances them by one stage of BK voxels
  Vox vox[A_COPIES];
#pragma unroll
  for (int j = 0; j < A_COPIES; ++j) vox[j] = decode(s, min(v_begin + a_k + (NT / 16) * j, s.v - 1));

  auto load_stage = [&](int kt, int slot) {
    const int v0 = v_begin + kt * BK;
    __nv_bfloat16* a_dst = As + slot * A_STAGE + a_c * 8;
#pragma unroll
    for (int j = 0; j < A_COPIES; ++j) {
      int k = a_k + (NT / 16) * j, v = v0 + k;
      bool ok = r.ok && v < v_end && tap_inside(s, r, vox[j]);
      cp_async16(a_dst + k * LDA, ok ? x + ((long long)v + r.delta) * s.cin + r.c : x, ok);
      advance(s, vox[j], BK);
    }
    int v = v0 + b_k;
    bool ok = b_ok && v < v_end;
    cp_async16(Bs + slot * B_STAGE + b_k * LDB + b_c * 8,
               ok ? g + (long long)v * s.cout + n0 + b_c * 8 : g, ok);
  };

  using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  Acc acc[2][2];
  float total[2][2][Acc::num_elements];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < Acc::num_elements; ++e) total[i][j][e] = 0.f;

  const int nk = (v_end - v_begin + BK - 1) / BK;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk) load_stage(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // step kt has landed
    __syncthreads();              // ... for every thread, and slot (kt-1) % STAGES is free
    if (kt + STAGES - 1 < nk) load_stage(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();
    const __nv_bfloat16* a_s = As + (kt % STAGES) * A_STAGE;
    const __nv_bfloat16* b_s = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], a_s + ks * LDA + wm * 32 + i * 16, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], b_s + ks * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < Acc::num_elements; ++e) total[i][j][e] += acc[i][j].x[e];
  }
  cp_async_wait<0>();
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < Acc::num_elements; ++e) acc[i][j].x[e] = total[i][j][e];
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
    }
  __syncthreads();

  float* out = part + (long long)blockIdx.z * s.m * s.cout;
  for (int i = tid; i < BM * TN; i += NT) {
    const int rr = i / TN, c = i % TN;
    const int m = m0 + rr, n = n0 + c;
    if (m < s.m && n < s.cout) out[(long long)m * s.cout + n] = Cs[rr * LDC + c];
  }
}

// dw[i] = sum over splits z, in order, of part[z][i]: deterministic.
__global__ void sum_splits(const float* __restrict__ part, float* __restrict__ dw, long long mn,
                           int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int z = 0; z < splits; ++z) acc += part[z * mn + i];
    dw[i] = acc;
  }
}

template <int KD>
void launch(const void* x, const void* g, float* out, const WShape& s, int splits, bool aligned16,
            int is_bf16, cudaStream_t st) {
  const unsigned m_tiles = (unsigned)((s.m + BM - 1) / BM);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* gb = static_cast<const __nv_bfloat16*>(g);
  const bool async = is_bf16 && s.cin % 8 == 0 && s.cout % 8 == 0 && aligned16;
  if (async && s.cout <= 32)
    wgrad_bf16_async<KD, 1><<<dim3(m_tiles, 1, splits), 128, 0, st>>>(xb, gb, out, s);
  else if (async)
    wgrad_bf16_async<KD, 2><<<dim3(m_tiles, (s.cout + 63) / 64, splits), 256, 0, st>>>(xb, gb, out, s);
  else if (is_bf16)
    wgrad_fma<KD, __nv_bfloat16><<<dim3(m_tiles, (s.cout + FBN - 1) / FBN, splits), FTHREADS, 0, st>>>(
        xb, gb, out, s);
  else
    wgrad_fma<KD, float><<<dim3(m_tiles, (s.cout + FBN - 1) / FBN, splits), FTHREADS, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), out, s);
}

}  // namespace

// x [N,D,H,W,Cin] and g [N,D,H,W,Cout] in one dtype (bf16 or f32), contiguous; dw f32
// [kd*9*Cin, Cout]; part f32 [splits, kd*9*Cin, Cout] (unused, may equal dw, when splits
// is 1). kd = 3 is the 3-D conv, kd = 1 the 2-D conv (D = 1). Each split covers `chunk`
// voxels (a multiple of 32). Launches on `stream` without synchronising and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape the kernels do not take.
extern "C" int conv3d_wgrad_launch(const void* x, const void* g, void* dw, void* part,
                                   long long n, int d, int h, int w, int cin, int cout, int kd,
                                   int chunk, int splits, int is_bf16, int device, void* stream) {
  const long long v = n * d * h * w;
  if ((kd != 1 && kd != 3) || v <= 0 || v >= (1LL << 31) || chunk <= 0 || chunk % BK != 0 ||
      splits < 1 || (long long)chunk * (splits - 1) >= v || (long long)chunk * splits < v)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  WShape s;
  s.v = (int)v;
  s.d = d; s.h = h; s.w = w; s.cin = cin; s.cout = cout; s.m = kd * 9 * cin;
  s.chunk = chunk;
  float* out = static_cast<float*>(splits > 1 ? part : dw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned16 = ((reinterpret_cast<unsigned long long>(x) |
                           reinterpret_cast<unsigned long long>(g)) & 15) == 0;
  if (kd == 3)
    launch<3>(x, g, out, s, splits, aligned16, is_bf16, st);
  else
    launch<1>(x, g, out, s, splits, aligned16, is_bf16, st);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long mn = (long long)s.m * cout;
  const int blocks = (int)((mn + 255) / 256 < 4096 ? (mn + 255) / 256 : 4096);
  sum_splits<<<blocks, 256, 0, st>>>(out, static_cast<float*>(dw), mn, splits);
  return (int)cudaGetLastError();
}
