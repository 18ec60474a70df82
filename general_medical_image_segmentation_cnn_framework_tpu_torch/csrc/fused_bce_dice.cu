// One-pass BCE-with-logits + dice metrics, and its gradient, for Hopper (sm_90a).
//
// For binary segmentation with logits [V, 2] (channels last, interleaved (l0, l1) per
// voxel) and a foreground mask g [V]:
//   forward   out = [ sum_v bce(l0, 1-g) + bce(l1, g),   the loss sum
//                     sum_v [l1 > l0] * [g > 0],          intersection
//                     sum_v [g > 0],                      gt sum
//                     sum_v [l1 > l0],                    pred sum
//                     loss sum / (2V),                    loss
//                     inter / (g + p - inter + smooth),   jaccard
//                     2 inter / (g + p + smooth) ]        dice
//   backward  d0 = (sigmoid(l0) - (1-g)) * s,  d1 = (sigmoid(l1) - g) * s,  s = ct / denom
// with bce(x, t) = max(x, 0) - x*t + log1p(exp(-|x|)); ct is the cotangent of the loss
// (denom = 2V) or a plain scale (denom = 1), read from device memory.
//
// Replaces the TPU kernels of the JAX package that compute these functions:
//   ops/fused.py _pallas_sums  (_fused_kernel): the forward, with the epilogue of
//                              fused_bce_dice_metrics that follows it
//   ops/fused.py _pallas_grads (_grad_kernel): the backward
// They read two de-interleaved planes padded to 1024-voxel tiles, with a 2*log(2)
// correction per padded voxel; here the kernels read the interleaved logits as they
// are and handle the ragged ends themselves.
//
// What bounds them on an H100: a few dozen operations per voxel against 12 bytes read
// (forward) or 12 read and 8 written (backward), far under the card's ridge, so bytes.
// At UNet2D's 262,144 voxels the 3 MB lie in L2 and a call is a few microseconds, so
// what else a call launches and waits for counts as much. The design:
// - one launch each way, nothing around it: the forward ends in the finished metrics
//   and the backward divides the cotangent itself, so a train step's loss is one
//   kernel forward and one backward;
// - each thread takes 4 voxels per turn with 16-byte loads (two of logits, one of g)
//   and stores, with a scalar head and tail for a V that is no multiple of 4 and
//   pointers that are not 16-byte aligned; where no head aligns all pointers at once
//   (an odd storage offset) the whole range goes by scalar loads;
// - the grid is sized from the SM count (BLOCKS_PER_SM blocks per SM at most), not V:
//   4 blocks of 256 threads keep 48 KB of loads in flight per SM, which holds the
//   memory busy (two turns in flight per thread, or 8 blocks, measured no faster);
// - the backward's sigmoid uses the fast exponential and division: with IEEE ones it
//   was the larger part of the time at UNet2D's size, where the data lie in L2;
// - the forward takes one log1p per voxel, log((1+e0)(1+e1)) = log1p(e0 + e1 + e0 e1),
//   and keeps the counts in 32-bit per thread, 64-bit per block;
// - each forward block writes one partial, then takes a ticket (__threadfence,
//   atomicAdd); the last block adds the partials in a fixed order (the loss in
//   double), writes the sums and the metrics and resets the ticket: the result is the
//   same bits on every run, with no float atomics and no second launch. The
//   workspace (partials and ticket) belongs to the caller, one per stream, zeroed once.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BLOCKS_PER_SM = 4;

struct Acc {
  float loss = 0.f;
  unsigned inter = 0, gsum = 0, psum = 0;
};

__device__ __forceinline__ void add_voxel(Acc& a, float l0, float l1, float t) {
  // bce(l0, 1-t) + bce(l1, t), the two log1p terms as one
  const float e0 = expf(-fabsf(l0)), e1 = expf(-fabsf(l1));
  a.loss += fmaxf(l0, 0.f) - l0 * (1.f - t) + (fmaxf(l1, 0.f) - l1 * t) + log1pf(e0 + e1 + e0 * e1);
  const bool p = l1 > l0, f = t > 0.f;
  a.inter += p && f;
  a.gsum += f;
  a.psum += p;
}

// The fast exponential and division: at most about 3e-7 from the exact sigmoid (|x| <=
// 2 is the worst: __expf's relative error times sigma (1 - sigma), plus the division's
// 2 ulp), under the 1e-6 the gradient is held to in units of its scale. __fdividef
// gives 0 where 1 + e^-x overflows, which is the limit.
__device__ __forceinline__ float sigmoid(float x) { return __fdividef(1.f, 1.f + __expf(-x)); }

// The first voxel from which logits + 2h, gt + h and (if given) d + 2h are all
// 16-byte aligned, or -1 where there is none.
long long vector_head(const void* logits, const void* gt, const void* d) {
  const unsigned a = (unsigned)(((uintptr_t)logits >> 2) & 3), b = (unsigned)(((uintptr_t)gt >> 2) & 3);
  if (((uintptr_t)logits | (uintptr_t)gt | (uintptr_t)d) & 3) return -1;
  const unsigned h = (4 - b) & 3;
  if ((a + 2 * h) & 3) return -1;
  if (d && ((((uintptr_t)d >> 2) + 2 * h) & 3)) return -1;
  return h;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
bce_dice_forward(const float* __restrict__ logits, const float* __restrict__ gt, long long v, long long head,
                 float denom, float smooth, float* __restrict__ out, float* __restrict__ loss_part,
                 unsigned long long* __restrict__ count_part, unsigned* __restrict__ ticket) {
  Acc a;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  if (VEC) {
    const long long n4 = (v - head) / 4, tail = head + 4 * n4;
    if (tid < head) add_voxel(a, logits[2 * tid], logits[2 * tid + 1], gt[tid]);
    if (tid < v - tail) add_voxel(a, logits[2 * (tail + tid)], logits[2 * (tail + tid) + 1], gt[tail + tid]);
    const float4* l4 = reinterpret_cast<const float4*>(logits + 2 * head);
    const float4* g4 = reinterpret_cast<const float4*>(gt + head);
    for (long long j = tid; j < n4; j += stride) {
      const float4 la = __ldg(l4 + 2 * j), lb = __ldg(l4 + 2 * j + 1), g = __ldg(g4 + j);
      add_voxel(a, la.x, la.y, g.x);
      add_voxel(a, la.z, la.w, g.y);
      add_voxel(a, lb.x, lb.y, g.z);
      add_voxel(a, lb.z, lb.w, g.w);
    }
  } else {
    for (long long i = tid; i < v; i += stride) add_voxel(a, logits[2 * i], logits[2 * i + 1], gt[i]);
  }

  // block: the loss in f32 and the counts in 32 bits within each warp, then the
  // counts in 64 bits across the warps
  for (int off = 16; off > 0; off /= 2) {
    a.loss += __shfl_down_sync(0xffffffffu, a.loss, off);
    a.inter += __shfl_down_sync(0xffffffffu, a.inter, off);
    a.gsum += __shfl_down_sync(0xffffffffu, a.gsum, off);
    a.psum += __shfl_down_sync(0xffffffffu, a.psum, off);
  }
  __shared__ float s_loss[WARPS];
  __shared__ unsigned s_count[3][WARPS];
  __shared__ double r_loss[WARPS];
  __shared__ unsigned long long r_count[3][WARPS];
  __shared__ bool last;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) {
    s_loss[warp] = a.loss;
    s_count[0][warp] = a.inter;
    s_count[1][warp] = a.gsum;
    s_count[2][warp] = a.psum;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float l = 0.f;
    unsigned long long c0 = 0, c1 = 0, c2 = 0;
    for (int w = 0; w < WARPS; ++w) {
      l += s_loss[w];
      c0 += s_count[0][w];
      c1 += s_count[1][w];
      c2 += s_count[2][w];
    }
    loss_part[blockIdx.x] = l;
    count_part[3 * blockIdx.x] = c0;
    count_part[3 * blockIdx.x + 1] = c1;
    count_part[3 * blockIdx.x + 2] = c2;
    __threadfence();  // the partial is visible to every block before the ticket is
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;

  // the last block: the partials in a fixed order, whichever block came last
  double l = 0.0;
  unsigned long long c0 = 0, c1 = 0, c2 = 0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += THREADS) {
    l += __ldcg(loss_part + b);  // from L2: the other blocks wrote them
    c0 += __ldcg(count_part + 3 * b);
    c1 += __ldcg(count_part + 3 * b + 1);
    c2 += __ldcg(count_part + 3 * b + 2);
  }
  for (int off = 16; off > 0; off /= 2) {
    l += __shfl_down_sync(0xffffffffu, l, off);
    c0 += __shfl_down_sync(0xffffffffu, c0, off);
    c1 += __shfl_down_sync(0xffffffffu, c1, off);
    c2 += __shfl_down_sync(0xffffffffu, c2, off);
  }
  if (lane == 0) {
    r_loss[warp] = l;
    r_count[0][warp] = c0;
    r_count[1][warp] = c1;
    r_count[2][warp] = c2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double total = 0.0;
    unsigned long long n0 = 0, n1 = 0, n2 = 0;
    for (int w = 0; w < WARPS; ++w) {
      total += r_loss[w];
      n0 += r_count[0][w];
      n1 += r_count[1][w];
      n2 += r_count[2][w];
    }
    // the epilogue of fused_bce_dice_metrics, in f32 and in its order
    const float loss_sum = (float)total, inter = (float)n0, gs = (float)n1, ps = (float)n2;
    out[0] = loss_sum;
    out[1] = inter;
    out[2] = gs;
    out[3] = ps;
    out[4] = loss_sum / denom;
    out[5] = inter / (gs + ps - inter + smooth);
    out[6] = 2.f * inter / (gs + ps + smooth);
    *ticket = 0;  // ready for the next launch on this workspace
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
bce_dice_backward(const float* __restrict__ logits, const float* __restrict__ gt, const float* __restrict__ ct,
                  float denom, float* __restrict__ d, long long v, long long head) {
  const float s = *ct / denom;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long stride = (long long)gridDim.x * THREADS;
  auto one = [&](long long i) {
    const float l0 = logits[2 * i], l1 = logits[2 * i + 1], t = gt[i];
    d[2 * i] = (sigmoid(l0) - (1.f - t)) * s;
    d[2 * i + 1] = (sigmoid(l1) - t) * s;
  };
  if (VEC) {
    const long long n4 = (v - head) / 4, tail = head + 4 * n4;
    if (tid < head) one(tid);
    if (tid < v - tail) one(tail + tid);
    const float4* l4 = reinterpret_cast<const float4*>(logits + 2 * head);
    const float4* g4 = reinterpret_cast<const float4*>(gt + head);
    float4* d4 = reinterpret_cast<float4*>(d + 2 * head);
    for (long long j = tid; j < n4; j += stride) {
      const float4 la = __ldg(l4 + 2 * j), lb = __ldg(l4 + 2 * j + 1), g = __ldg(g4 + j);
      d4[2 * j] = make_float4((sigmoid(la.x) - (1.f - g.x)) * s, (sigmoid(la.y) - g.x) * s,
                              (sigmoid(la.z) - (1.f - g.y)) * s, (sigmoid(la.w) - g.y) * s);
      d4[2 * j + 1] = make_float4((sigmoid(lb.x) - (1.f - g.z)) * s, (sigmoid(lb.y) - g.z) * s,
                                  (sigmoid(lb.z) - (1.f - g.w)) * s, (sigmoid(lb.w) - g.w) * s);
    }
  } else {
    for (long long i = tid; i < v; i += stride) one(i);
  }
}

int grid_for(long long work, int sms) {
  const long long need = (work + THREADS - 1) / THREADS;
  const long long most = (long long)sms * BLOCKS_PER_SM;
  return (int)(need < 1 ? 1 : (need > most ? most : need));
}

cudaError_t on_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return err;
}

}  // namespace

// Bytes of the forward's workspace on a card with `sms` SMs: a 64-bit count triple and
// a float per block, and the ticket. The caller zeroes it once; the kernel leaves it
// zeroed.
extern "C" long long bce_dice_workspace_bytes(int sms) {
  return (long long)sms * BLOCKS_PER_SM * (3 * 8 + 4) + 4;
}

// logits [V, 2] f32, gt [V] f32, out f32 [7] (the four sums, loss, jaccard, dice), on
// `device`, 4-byte aligned; workspace of bce_dice_workspace_bytes(sms) bytes, 8-byte
// aligned and zeroed before its first use, used by one stream at a time. loss =
// sum / denom (2V in f32). One launch on `stream`, no synchronisation; returns
// cudaGetLastError().
extern "C" int bce_dice_forward_launch(const float* logits, const float* gt, float* out, void* workspace,
                                       long long v, float denom, float smooth, int sms, int device,
                                       void* stream) {
  if (v <= 0 || sms <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = on_device(device);
  if (err != cudaSuccess) return (int)err;
  const int most = sms * BLOCKS_PER_SM;
  auto* counts = static_cast<unsigned long long*>(workspace);
  auto* loss = reinterpret_cast<float*>(counts + 3 * most);
  auto* ticket = reinterpret_cast<unsigned*>(loss + most);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long head = vector_head(logits, gt, nullptr);
  if (head >= 0 && v - head >= 4) {
    const int blocks = grid_for((v - head) / 4, sms);
    bce_dice_forward<true><<<blocks, THREADS, 0, st>>>(logits, gt, v, head, denom, smooth, out, loss, counts, ticket);
  } else {
    const int blocks = grid_for(v, sms);
    bce_dice_forward<false><<<blocks, THREADS, 0, st>>>(logits, gt, v, 0, denom, smooth, out, loss, counts, ticket);
  }
  return (int)cudaGetLastError();
}

// logits [V, 2], d [V, 2], gt [V] and ct [1], all f32 on `device`, 4-byte aligned.
// d = gradient of the loss sum times ct / denom. One launch on `stream`, no
// synchronisation; returns cudaGetLastError().
extern "C" int bce_dice_backward_launch(const float* logits, const float* gt, const float* ct, float denom,
                                        float* d, long long v, int sms, int device, void* stream) {
  if (v <= 0 || sms <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = on_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long head = vector_head(logits, gt, d);
  if (head >= 0 && v - head >= 4) {
    bce_dice_backward<true><<<grid_for((v - head) / 4, sms), THREADS, 0, st>>>(logits, gt, ct, denom, d, v, head);
  } else {
    bce_dice_backward<false><<<grid_for(v, sms), THREADS, 0, st>>>(logits, gt, ct, denom, d, v, 0);
  }
  return (int)cudaGetLastError();
}
