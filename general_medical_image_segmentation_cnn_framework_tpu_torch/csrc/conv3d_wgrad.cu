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
// math from 32 channels up and by bytes below (the Cin = 1 stem). In practice the
// tensor-core variants are held by how fast their tiles arrive: x gathered once per tap
// would come 27 times per conv from L2, so the widest convs take a variant that gathers
// each x row once for its three dx taps. All element offsets are 64-bit; voxel coordinates are decoded in 32 bits (by multiply
// and shift), so V must stay below 2^31 (the launcher checks).
//
// The launcher picks one of four variants from what it can see of the call:
//   bf16, Cin and Cout multiples of 8, 16-byte aligned pointers (every UNet3D and UNet2D
//     conv but the stem), Cout <= 64: wgrad_slab, wgmma m64n96k16 on an mbarrier ring
//     fed by two producer warpgroups; each gathered x row serves the three dx taps;
//   the same with Cout > 64: wgrad_gather, wgmma m64n128k16 on 128 rows per block, x
//     gathered per tap by one producer warpgroup;
//   bf16 stem (Cin = 1, Cout a multiple of 8 up to 64): wgrad_stem, exact f32 FMA on
//     tiles of 256 voxels held once in shared memory;
//   other bf16 and f32: wgrad_fma, scalar loads into f32 tiles and a register-tiled FMA
//     (exact f32, no TF32).
// Both wgmma variants write their tiles with 16-byte cp.async copies (zero-filled in the
// SAME padding) at the swizzled addresses that wgmma's descriptors name, and hand them
// from the producer to the consumer warpgroups through a 4-step mbarrier ring
// (hopper_gemm.cuh).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_gemm.cuh"

namespace {

constexpr int BM = 128;  // rows of dw (tap, ci) per block of wgrad_fma
constexpr int BK = 32;   // voxels per reduction step of wgrad_fma

struct WShape {
  int v;                    // voxels N*D*H*W
  int d, h, w, cin, cout;
  int m;                    // KD*9*cin
  int chunk;                // voxels per split
  hopper::FastDiv fw, fh, fd;  // by w, h, d: voxel coordinates without divisions
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

// (d, h, w) of voxel v.
struct Vox {
  int d, h, w;
};

__device__ __forceinline__ Vox decode(const WShape& s, int v) {
  const uint32_t q = s.fw.div((uint32_t)v), q2 = s.fh.div(q);
  Vox c;
  c.w = v - (int)q * s.w;
  c.h = (int)(q - q2 * (uint32_t)s.h);
  c.d = (int)(q2 - s.fd.div(q2) * (uint32_t)s.d);
  return c;
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

// The SAME-padding validity of every tap at output voxel (d, h, w): bit tap (the layout
// index (dz*3+dy)*3+dx of dw) is set iff the x voxel under it lies in the volume.
template <int KD>
__device__ __forceinline__ uint32_t tap_mask(const WShape& s, int d, int h, int w) {
  const uint32_t mx = 2u | (w > 0 ? 1u : 0u) | (w < s.w - 1 ? 4u : 0u);
  const uint32_t my = 2u | (h > 0 ? 1u : 0u) | (h < s.h - 1 ? 4u : 0u);
  const uint32_t plane = (my & 1u ? mx : 0u) | (my & 2u ? mx << 3 : 0u) | (my & 4u ? mx << 6 : 0u);
  if (KD == 1) return plane;
  const uint32_t mz = 2u | (d > 0 ? 1u : 0u) | (d < s.d - 1 ? 4u : 0u);
  return (mz & 1u ? plane : 0u) | (mz & 2u ? plane << 9 : 0u) | (mz & 4u ? plane << 18 : 0u);
}

// bf16 with Cin and Cout multiples of 8 and Cout > 64 (UNet3D's 16^3 to 4^3 convs,
// UNet2D's 64^2 to 8^2 ones), on wgmma. A block owns BM = 128 rows of dw by TN = 128
// output channels and one split of the voxels. Warpgroup 2 is the producer: for each
// step of BK = 64 voxels it gathers the A tile (x under each row's tap: 16-byte cp.async
// of 8 channels of one tap, zero-filled in the SAME padding) and the g tile into the
// ring, both MN-major (channels contiguous, voxels along K) and swizzled; the validity
// of all taps of the step's 64 voxels is decoded once, by 64 threads, into a bit mask
// per voxel, and each copy tests one bit. Warpgroups 0 and 1 each multiply 64 of the
// rows (wgmma m64n128k16, both operands from shared memory) as the slots fill; a step's
// wgmma group stays in flight while the next slot is awaited.
// The tensor cores' f32 accumulator does not round to nearest, an error that grows
// with its magnitude (over the ~10^5 voxels of a split it reached 1e-4 of the result,
// measured on the H100 against an f64 sum). So wgmma sums FLUSH steps (FLUSH * BK
// voxels) in a fresh accumulator, which is then added, rounded to nearest, into f32
// registers that hold the split's total.
namespace ga {
constexpr int BK = 64, BM = 128, TN = 128, STAGES = 4, FLUSH = 4;  // a ring of 7 steps measured slower
constexpr int P = 128;  // producer threads: one warpgroup
using ATile = hopper::MnTile<BK, BM>;  // [voxel][row m]
using BTile = hopper::MnTile<BK, TN>;  // [voxel][output channel]
constexpr int STAGE_BYTES = ATile::BYTES + BTile::BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;
}  // namespace ga

template <int KD>
__global__ void __launch_bounds__(256 + ga::P, 1)
wgrad_gather(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
             float* __restrict__ part, WShape s) {
  using ATile = ga::ATile;
  using BTile = ga::BTile;
  constexpr int TN = ga::TN, STAGE = ga::STAGE_BYTES;
  extern __shared__ __align__(1024) unsigned char dyn[];
  __shared__ hopper::Ring<ga::STAGES> ring;
  __shared__ uint32_t vmask[2][ga::BK];
  const uint32_t smem = (hopper::smem_u32(dyn) + 1023u) & ~1023u;
  const int m0 = blockIdx.x * ga::BM, n0 = blockIdx.y * TN;
  const int v_begin = blockIdx.z * s.chunk;
  const int v_end = min(v_begin + s.chunk, s.v);
  const int nk = (v_end - v_begin + ga::BK - 1) / ga::BK;
  const int t = threadIdx.x % 128;
  constexpr int P = ga::P;
  if (threadIdx.x == 0) ring.init(8, P / 32);  // the consumer and producer warps
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producers: A rows m0 + 8*mc .. +8 (8 channels of one tap) at K-rows r + (P/16)*j;
    // g chunk nc at K-rows kb + (P/BC)*i
    const int p = threadIdx.x - 256;
    const int mc = p % 16, r = p / 16;
    const Row row = row_of<KD>(s, m0 + 8 * mc);
    const int tap = row.ok ? (m0 + 8 * mc) / s.cin : 0;
    const __nv_bfloat16* xa = x + row.delta * s.cin + row.c;  // read only where the tap is inside
    constexpr int BC = TN / 8, A_COPIES = ga::BK * 16 / P, B_COPIES = ga::BK * BC / P;
    const int nc = p % BC, kb = p / BC;
    const bool n_ok = n0 + 8 * nc < s.cout;
    const __nv_bfloat16* gb = g + n0 + 8 * nc;
    for (int it = 0; it < nk; ++it) {
      const int v0 = v_begin + it * ga::BK;
      uint32_t* mk = vmask[it & 1];
      if (p < ga::BK) {
        const int v = v0 + p;
        uint32_t bits = 0;
        if (v < v_end) {
          const Vox c = decode(s, v);
          bits = tap_mask<KD>(s, c.d, c.h, c.w);
        }
        mk[p] = bits;
      }
      hopper::bar_sync(1, P);
      ring.acquire(it);
      const uint32_t a_s = smem + (it % ga::STAGES) * STAGE, b_s = a_s + ATile::BYTES;
      const __nv_bfloat16* xs = xa + (long long)(v0 + r) * s.cin;
#pragma unroll
      for (int j = 0; j < A_COPIES; ++j) {
        const int k = r + (P / 16) * j;
        const bool ok = row.ok && ((mk[k] >> tap) & 1u);
        hopper::cp_async16(a_s + ATile::chunk(k, mc), ok ? xs + (long long)((P / 16) * j) * s.cin : x, ok);
      }
#pragma unroll
      for (int i = 0; i < B_COPIES; ++i) {
        const int k = kb + (P / BC) * i;
        const bool ok = n_ok && v0 + k < v_end;
        hopper::cp_async16(b_s + BTile::chunk(k, nc), ok ? gb + (long long)(v0 + k) * s.cout : g, ok);
      }
      ring.commit(it);
    }
    ring.drain(nk);
  } else {
    const int wgi = threadIdx.x / 128;
    float acc[TN / 2], total[TN / 2];
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc[i] = total[i] = 0.f;
    bool fresh = true;
    int pending = -1;  // the step whose wgmma group may still run, not yet released
    for (int it = 0; it < nk; ++it) {
      ring.consume(it);
      hopper::fence_proxy_async();
      const uint32_t a_s = smem + (it % ga::STAGES) * STAGE, b_s = a_s + ATile::BYTES;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < ga::BK / 16; ++kk)
        hopper::wgmma<TN, 1, 1>(acc, ATile::desc(a_s, kk, wgi), BTile::desc(b_s, kk, 0),
                                (fresh && kk == 0) ? 0 : 1);
      hopper::wgmma_commit();
      fresh = it % ga::FLUSH == ga::FLUSH - 1 || it == nk - 1;
      if (fresh) {
        hopper::wgmma_wait<0>();
        hopper::fence_regs<TN / 2>(acc);
        if (pending >= 0) ring.release(pending);
        ring.release(it);
        pending = -1;
#pragma unroll
        for (int i = 0; i < TN / 2; ++i) total[i] += acc[i];
      } else {
        hopper::wgmma_wait<1>();
        if (pending >= 0) ring.release(pending);
        pending = it;
      }
    }
    float* out = part + (long long)blockIdx.z * s.m * s.cout;
#pragma unroll
    for (int i = 0; i < TN / 2; i += 2) {
      const int m = m0 + 64 * wgi + hopper::acc_row(t, i), n = n0 + hopper::acc_col(t, i);
      if (m < s.m && n < s.cout)
        *reinterpret_cast<float2*>(out + (long long)m * s.cout + n) = make_float2(total[i], total[i + 1]);
    }
  }
}

// bf16 with Cin and Cout multiples of 8 and Cout <= 64 (the widest, full-resolution
// convs): each gathered x row serves the three dx taps. The rows of dw are taken in
// "columns" of 64: flat channel f = 64*col + r is channel f % Cin of the (dz, dy) pair
// q = f / Cin (a column holds two pairs at Cin = 32, a part of one at Cin >= 64). For
// each step of BK = 64 voxels u in [u0, u0 + 64) the two producer warpgroups (one could
// not keep up: the copies per step are 1.5-2.5 times the gather variant's) gather, per
// column, the "slab" S[u] = x[u + delta(dz, dy)] (zero where (d+dz, h+dy) of u leaves
// the volume), and three shifted, masked copies of the g tile, G'_dx[u] = g[u - dx]
// where u - dx is a voxel of the split whose w + dx stays in the volume, 0 elsewhere.
// Then sum_u S[u] G'_dx[u] = sum_v x[v + delta + dx] g[v] over the voxels v = u - dx
// whose tap is inside (v + dx stays in v's row wherever G' is not 0), and the three dx
// taps are one GEMM: D[64 channels, 3 x TN] = S^T [G'_-1 | G'_0 | G'_+1]. A block holds
// two columns, one per consumer warpgroup (wgmma m64n96k16 at TN = 32, m64n192k16 at
// TN = 64), that share the G' tiles. So x comes from L2 9 times per conv, not 27, and
// wgmma reads each slab row once for all three taps. The split's
// steps cover u from v_begin - 1 to v_end, the voxels that its v = u - dx can reach.
// Accumulation as above: FLUSH steps in wgmma's accumulator, then rounded into f32
// registers; a step's wgmma group stays in flight while the next slot is awaited.
namespace sl {
constexpr int BK = 64, FLUSH = 4, NCOL = 2;  // NCOL slab columns per block, one per consumer warpgroup
constexpr int P = 256;                        // producer threads: two warpgroups
using STile = hopper::MnTile<BK, 64>;         // one slab column: [voxel][64 channels]
template <int TN>
using GTile = hopper::MnTile<BK, 3 * TN, 32>;  // [voxel][dx * TN + output channel], 32-wide atoms
template <int TN>
constexpr int STAGE_BYTES = NCOL * STile::BYTES + GTile<TN>::BYTES;
// At TN = 64 the split's totals (96 per thread) live in shared memory: in registers,
// beside the 96 of the accumulator, they would leave the producers none. Then only 3
// steps fit; 4 at TN = 32 (deeper rings, 7-8 steps, measured no faster).
template <int TN>
constexpr int STAGES = TN == 32 ? 4 : 3;
template <int TN>
constexpr int TOTAL_BYTES = TN == 32 ? 0 : NCOL * (3 * TN / 2) * 128 * 4;
template <int TN>
constexpr int SMEM_BYTES = STAGES<TN> * STAGE_BYTES<TN> + TOTAL_BYTES<TN> + 1024;
}  // namespace sl

template <int KD, int TN>
__global__ void __launch_bounds__(256 + sl::P, 1)
wgrad_slab(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
           float* __restrict__ part, WShape s) {
  using STile = sl::STile;
  using GTile = sl::GTile<TN>;
  constexpr int NCOL = sl::NCOL, STAGE = sl::STAGE_BYTES<TN>, STAGES = sl::STAGES<TN>;
  extern __shared__ __align__(1024) unsigned char dyn[];
  __shared__ hopper::Ring<STAGES> ring;
  __shared__ uint32_t info[2][sl::BK + 2];
  const uint32_t smem = (hopper::smem_u32(dyn) + 1023u) & ~1023u;
  const int n0 = blockIdx.y * TN;
  const int v_begin = blockIdx.z * s.chunk;
  const int v_end = min(v_begin + s.chunk, s.v);
  const int nk = (v_end - v_begin + 2 + sl::BK - 1) / sl::BK;
  const int t = threadIdx.x % 128;
  constexpr int P = sl::P;
  if (threadIdx.x == 0) ring.init(8, P / 32);  // the consumer and producer warps
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producers: slab chunk c of rows r0 + (P/8)j of each column; g chunk (dx, nc) of rows
    // kb + (P/BC)*i
    const int p = threadIdx.x - 256;
    const int c = p % 8, r0 = p / 8;
    const __nv_bfloat16* xq[NCOL];
    int q[NCOL];
#pragma unroll
    for (int k = 0; k < NCOL; ++k) {
      const int f = 64 * (NCOL * blockIdx.x + k) + 8 * c;
      q[k] = f / s.cin;
      const int dz = KD == 3 ? q[k] / 3 - 1 : 0, dy = KD == 3 ? q[k] % 3 - 1 : q[k] - 1;
      xq[k] = x + ((long long)dz * s.h + dy) * s.w * s.cin + (f - q[k] * s.cin);
      if (q[k] >= KD * 3) q[k] = 31;  // past the taps: never valid (bit 31 is never set)
    }
    constexpr int BC = TN / 8, G_COPIES = (sl::BK * BC + P - 1) / P;
    const int nc = p % BC, kb = p / BC;
    const bool n_ok = n0 + 8 * nc < s.cout;
    const __nv_bfloat16* gb = g + n0 + 8 * nc;
    for (int it = 0; it < nk; ++it) {
      const int u0 = v_begin - 1 + it * sl::BK;
      uint32_t* in = info[it & 1];
      if (p < sl::BK + 2) {
        // voxel u0 - 1 + p: bits 0..8 (dz, dy) pair q inside, 9 w > 0, 10 w < W - 1,
        // 11 inside the split
        const int u = u0 - 1 + p;
        uint32_t bits = 0;
        if (u >= 0 && u < s.v) {
          const Vox v = decode(s, u);
          const uint32_t my = 2u | (v.h > 0 ? 1u : 0u) | (v.h < s.h - 1 ? 4u : 0u);
          uint32_t zy = my;
          if (KD == 3) {
            const uint32_t mz = 2u | (v.d > 0 ? 1u : 0u) | (v.d < s.d - 1 ? 4u : 0u);
            zy = (mz & 1u ? my : 0u) | (mz & 2u ? my << 3 : 0u) | (mz & 4u ? my << 6 : 0u);
          }
          bits = zy | (v.w > 0 ? 1u << 9 : 0u) | (v.w < s.w - 1 ? 1u << 10 : 0u) |
                 (u >= v_begin && u < v_end ? 1u << 11 : 0u);
        }
        in[p] = bits;
      }
      hopper::bar_sync(1, P);
      ring.acquire(it);
      const uint32_t a_s = smem + (it % STAGES) * STAGE, g_s = a_s + NCOL * STile::BYTES;
#pragma unroll
      for (int j = 0; j < (sl::BK * 8 + P - 1) / P; ++j) {
        const int row = r0 + (P / 8) * j;
        if (row >= sl::BK) break;
        const uint32_t bits = in[row + 1];
#pragma unroll
        for (int k = 0; k < NCOL; ++k) {
          const bool ok = (bits >> q[k]) & 1u;
          hopper::cp_async16(a_s + k * STile::BYTES + STile::chunk(row, c),
                             ok ? xq[k] + (long long)(u0 + row) * s.cin : x, ok);
        }
      }
#pragma unroll
      for (int i = 0; i < G_COPIES; ++i) {
        const int row = kb + (P / BC) * i;
        if (row >= sl::BK) break;
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {  // G'_dx[u] = g[u - dx], its info at row - dx + 1
          const uint32_t bits = in[row - dx + 1];
          const bool ok = n_ok && ((bits >> 11) & 1u) &&
                          (dx == 0 || ((bits >> (dx < 0 ? 9 : 10)) & 1u));
          hopper::cp_async16_ca(g_s + GTile::chunk(row, (dx + 1) * BC + nc),
                                ok ? gb + (long long)(u0 + row - dx) * s.cout : g, ok);
        }
      }
      ring.commit(it);
    }
    ring.drain(nk);
  } else {
    const int wgi = threadIdx.x / 128, col = NCOL * blockIdx.x + wgi;
    constexpr int R = 3 * TN / 2;  // accumulator registers: the 64 x 3TN tile of the column
    // the split's totals: registers at TN = 32, shared memory (element i of thread t at
    // [i][t]) at TN = 64
    float acc[R], reg_total[TN == 32 ? R : 1];
    float* smem_total = reinterpret_cast<float*>(dyn + (smem - hopper::smem_u32(dyn)) + STAGES * STAGE) +
                        wgi * R * 128 + t;
    auto total = [&](int i) -> float& { return TN == 32 ? reg_total[TN == 32 ? i : 0] : smem_total[128 * i]; };
#pragma unroll
    for (int i = 0; i < R; ++i) acc[i] = total(i) = 0.f;
    bool fresh = true;
    int pending = -1;  // the step whose wgmma group may still run, not yet released
    for (int it = 0; it < nk; ++it) {
      ring.consume(it);
      hopper::fence_proxy_async();
      const uint32_t a_s = smem + (it % STAGES) * STAGE;
      const uint32_t s_s = a_s + wgi * STile::BYTES, g_s = a_s + NCOL * STile::BYTES;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < sl::BK / 16; ++kk)
        hopper::wgmma<3 * TN, 1, 1>(acc, STile::desc(s_s, kk, 0), GTile::desc(g_s, kk, 0),
                                    (fresh && kk == 0) ? 0 : 1);
      hopper::wgmma_commit();
      fresh = it % sl::FLUSH == sl::FLUSH - 1 || it == nk - 1;
      if (fresh) {
        hopper::wgmma_wait<0>();
        hopper::fence_regs<R>(acc);
        if (pending >= 0) ring.release(pending);
        ring.release(it);
        pending = -1;
#pragma unroll
        for (int i = 0; i < R; ++i) total(i) += acc[i];
      } else {
        hopper::wgmma_wait<1>();
        if (pending >= 0) ring.release(pending);
        pending = it;
      }
    }
    float* out = part + (long long)blockIdx.z * s.m * s.cout;
#pragma unroll
    for (int i = 0; i < R; i += 2) {
      const int f = 64 * col + hopper::acc_row(t, i), q = f / s.cin;
      const int o = hopper::acc_col(t, i);  // dx tile o / TN, channel o % TN
      const int n = n0 + o % TN;
      if (q < KD * 3 && n < s.cout) {
        const int m = (q * 3 + o / TN) * s.cin + (f - q * s.cin);
        *reinterpret_cast<float2*>(out + (long long)m * s.cout + n) = make_float2(total(i), total(i + 1));
      }
    }
  }
}

// bf16 stem (Cin = 1, Cout a multiple of 8 up to 64): dw has only KD*9 rows, so a tile
// of 64 or 128 rows would stay mostly empty, and it is bound by bytes (x and g read once:
// 0.08 ms at 16 x 64^3 x 32, against 7 GFLOP). A block walks its split in tiles of ST_V
// voxels, double-buffered in shared memory: while it multiplies one tile it has the
// next one's global loads in flight. Per tile it holds g's rows (bf16), the valid taps
// of each voxel (a 27-bit mask, decoded once per voxel), and for each of the KD*3
// (dz, dy) rows the contiguous x range under the tile with a voxel of halo on each side,
// so that the three dx taps of voxel i are entries i, i+1, i+2 of it. Each thread owns
// one (dz, dy) row and 8 output channels, for all 3 dx taps: 24 f32 FMA accumulators
// over its share of the tile's voxels (the block's threads split the voxels in `lanes`
// interleaved shares); the shares are summed in a fixed order at the end. Exact f32
// products and sums: no tensor cores, so no accumulator rounding.
constexpr int ST_V = 256;       // voxels per tile
constexpr int ST_THREADS = 256;
constexpr int ST_GROUPS = 8;    // at most 8 groups of 8 output channels (Cout <= 64)

struct StemPlan {
  int groups, rows, roles, lanes, xn, bytes;
};
__host__ __device__ inline StemPlan stem_plan(int kd, int cout) {
  StemPlan p;
  p.groups = cout / 8;
  p.rows = kd * 3;
  p.roles = p.rows * p.groups;
  p.lanes = p.roles > 0 ? ST_THREADS / p.roles : 0;
  p.xn = ST_V + 2;  // x entries per (dz, dy) row: the tile and its dx halo
  const int tile = 2 * (ST_V * cout * 2 + p.rows * p.xn * 4 + ST_V * 4);
  const int red = p.lanes * p.roles * 24 * 4;
  p.bytes = tile > red ? tile : red;
  return p;
}

template <int KD>
__global__ void __launch_bounds__(ST_THREADS, 2)
wgrad_stem(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
           float* __restrict__ part, WShape s) {
  extern __shared__ float4 stem_smem[];
  const StemPlan p = stem_plan(KD, s.cout);
  // per buffer b: g rows [ST_V][cout] bf16, x rows [rows][xn] f32, tap masks [ST_V]
  auto gs = [&](int b) { return reinterpret_cast<__nv_bfloat16*>(stem_smem) + b * ST_V * s.cout; };
  auto xs = [&](int b) {
    return reinterpret_cast<float*>(reinterpret_cast<__nv_bfloat16*>(stem_smem) + 2 * ST_V * s.cout) +
           b * p.rows * p.xn;
  };
  auto mk = [&](int b) { return reinterpret_cast<uint32_t*>(xs(2)) + b * ST_V; };
  const int tid = threadIdx.x, role = tid % p.roles, lane = tid / p.roles;
  const int zy = role / p.groups, cg = role % p.groups;
  const int v_begin = blockIdx.z * s.chunk;
  const int v_end = min(v_begin + s.chunk, s.v);
  const int ntiles = (v_end - v_begin + ST_V - 1) / ST_V;

  // the next tile: g's rows by cp.async straight into shared memory, the x rows and
  // the tap mask in registers until the current tile is multiplied
  __nv_bfloat16 xreg[(KD * 3 * (ST_V + 2) + ST_THREADS - 1) / ST_THREADS];
  uint32_t mreg = 0;
  auto load = [&](int v0, int b) {
    const int v = v0 + tid;
    const bool ok = v < v_end;
    for (int k = 0; k < p.groups; ++k)
      hopper::cp_async16(hopper::smem_u32(gs(b) + tid * s.cout + 8 * k), ok ? g + (long long)v * s.cout + 8 * k : g,
                         ok);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    mreg = 0;
    if (ok) {
      const Vox c = decode(s, v);
      mreg = tap_mask<KD>(s, c.d, c.h, c.w);
    }
#pragma unroll
    for (int k = 0; k < (int)(sizeof(xreg) / sizeof(xreg[0])); ++k) {
      const int item = tid + ST_THREADS * k, q = item / (ST_V + 2), i = item - q * (ST_V + 2);
      const long long u = (long long)v0 - 1 + i + ((long long)(KD == 3 ? q / 3 - 1 : 0) * s.h + q % 3 - 1) * s.w;
      xreg[k] = item < p.rows * p.xn && u >= 0 && u < s.v ? x[u] : __float2bfloat16(0.f);
    }
  };
  auto store = [&](int b) {
    mk(b)[tid] = mreg;
#pragma unroll
    for (int k = 0; k < (int)(sizeof(xreg) / sizeof(xreg[0])); ++k) {
      const int item = tid + ST_THREADS * k;
      if (item < p.rows * p.xn) xs(b)[item] = __bfloat162float(xreg[k]);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  };

  float acc[3][8];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[a][e] = 0.f;
  if (ntiles > 0) {
    load(v_begin, 0);
    store(0);
  }
  __syncthreads();
  for (int tile = 0; tile < ntiles; ++tile) {
    const int b = tile & 1;
    if (tile + 1 < ntiles) load(v_begin + (tile + 1) * ST_V, b ^ 1);
    if (lane < p.lanes) {
      const float* xr = xs(b) + zy * p.xn;
      const uint32_t* m = mk(b);
      const __nv_bfloat16* gr = gs(b) + 8 * cg;
#pragma unroll 4
      for (int vi = lane; vi < ST_V; vi += p.lanes) {
        const uint32_t bits = m[vi] >> (3 * zy);
        const float xv[3] = {bits & 1u ? xr[vi] : 0.f, bits & 2u ? xr[vi + 1] : 0.f, bits & 4u ? xr[vi + 2] : 0.f};
        const uint4 raw = *reinterpret_cast<const uint4*>(gr + vi * s.cout);
        const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
        float gv[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(b2[e]);
          gv[2 * e] = f.x;
          gv[2 * e + 1] = f.y;
        }
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[a][e] = fmaf(xv[a], gv[e], acc[a][e]);
      }
    }
    if (tile + 1 < ntiles) store(b ^ 1);
    __syncthreads();
  }

  float* red = reinterpret_cast<float*>(stem_smem);  // [lanes][roles][24]
  if (lane < p.lanes) {
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int e = 0; e < 8; ++e) red[(lane * p.roles + role) * 24 + a * 8 + e] = acc[a][e];
  }
  __syncthreads();
  float* out = part + (long long)blockIdx.z * s.m * s.cout;
  for (int o = tid; o < p.roles * 24; o += ST_THREADS) {
    const int ro = o / 24, e = o % 24;
    float sum = 0.f;
    for (int l = 0; l < p.lanes; ++l) sum += red[(l * p.roles + ro) * 24 + e];
    const int tap = (ro / p.groups) * 3 + e / 8, co = 8 * (ro % p.groups) + e % 8;
    out[(long long)tap * s.cout + co] = sum;
  }
}

// dw[i] = sum over splits z, in order, of part[z][i]: deterministic.
__global__ void sum_splits(const float* __restrict__ part, float* __restrict__ dw, long long mn,
                           int splits) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < mn;
       i += (long long)gridDim.x * blockDim.x) {
    float acc = 0.f;
#pragma unroll 8
    for (int z = 0; z < splits; ++z) acc += part[z * mn + i];
    dw[i] = acc;
  }
}

template <int KD>
void launch_gather(const __nv_bfloat16* x, const __nv_bfloat16* g, float* out, const WShape& s, int splits,
                   cudaStream_t st) {
  static const cudaError_t attr =  // once per instantiation
      cudaFuncSetAttribute(wgrad_gather<KD>, cudaFuncAttributeMaxDynamicSharedMemorySize, ga::SMEM_BYTES);
  (void)attr;
  const dim3 grid((unsigned)((s.m + ga::BM - 1) / ga::BM), (unsigned)((s.cout + ga::TN - 1) / ga::TN),
                  (unsigned)splits);
  wgrad_gather<KD><<<grid, 256 + ga::P, ga::SMEM_BYTES, st>>>(x, g, out, s);
}

template <int KD, int TN>
void launch_slab(const __nv_bfloat16* x, const __nv_bfloat16* g, float* out, const WShape& s, int splits,
                 cudaStream_t st) {
  constexpr int bytes = sl::SMEM_BYTES<TN>;
  static const cudaError_t attr =  // once per instantiation
      cudaFuncSetAttribute(wgrad_slab<KD, TN>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  (void)attr;
  const int cols = (KD * 3 * s.cin + 63) / 64;
  const dim3 grid((unsigned)((cols + sl::NCOL - 1) / sl::NCOL), (unsigned)((s.cout + TN - 1) / TN),
                  (unsigned)splits);
  wgrad_slab<KD, TN><<<grid, 256 + sl::P, bytes, st>>>(x, g, out, s);
}

template <int KD>
void launch(const void* x, const void* g, float* out, const WShape& s, int splits, bool aligned16,
            int is_bf16, cudaStream_t st) {
  const unsigned m_tiles = (unsigned)((s.m + BM - 1) / BM);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* gb = static_cast<const __nv_bfloat16*>(g);
  const bool tiled = is_bf16 && s.cin % 8 == 0 && s.cout % 8 == 0 && aligned16;
  const StemPlan stem = stem_plan(KD, s.cout);
  if (tiled && s.cout <= 32)
    launch_slab<KD, 32>(xb, gb, out, s, splits, st);
  else if (tiled && s.cout <= 64)
    launch_slab<KD, 64>(xb, gb, out, s, splits, st);
  else if (tiled)
    launch_gather<KD>(xb, gb, out, s, splits, st);
  else if (is_bf16 && s.cin == 1 && s.cout % 8 == 0 && s.cout <= 8 * ST_GROUPS && aligned16) {
    static const cudaError_t attr =  // once per instantiation; the plan's largest is 74 KB (Cout = 64)
        cudaFuncSetAttribute(wgrad_stem<KD>, cudaFuncAttributeMaxDynamicSharedMemorySize, stem_plan(KD, 64).bytes);
    (void)attr;
    wgrad_stem<KD><<<dim3(1, 1, splits), ST_THREADS, stem.bytes, st>>>(xb, gb, out, s);
  }
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
  s.fw = hopper::FastDiv((uint32_t)w);
  s.fh = hopper::FastDiv((uint32_t)h);
  s.fd = hopper::FastDiv((uint32_t)d);
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
