// One-pass BCE-with-logits + dice counts, and its gradient, for Hopper (sm_90a).
//
// For binary segmentation with logits [V, 2] (channels last, interleaved (l0, l1) per
// voxel) and a foreground mask g [V]:
//   sums   = [ sum_v bce(l0, 1-g) + bce(l1, g),      the loss sum
//              sum_v [l1 > l0] * [g > 0],             intersection
//              sum_v [g > 0],                         gt sum
//              sum_v [l1 > l0] ]                      pred sum
//   grads  = d0 = (sigmoid(l0) - (1-g)) * s,  d1 = (sigmoid(l1) - g) * s
// with bce(x, t) = max(x, 0) - x*t + log1p(exp(-|x|)) and s the cotangent of the loss sum.
//
// Replaces the TPU kernels of the JAX package that compute these functions:
//   ops/fused.py _pallas_sums  (_fused_kernel)
//   ops/fused.py _pallas_grads (_grad_kernel)
// They read two de-interleaved planes padded to 1024-voxel tiles, with a 2*log(2)
// correction per padded voxel; here the kernels read the interleaved logits as they
// are and bounds-check the tail.
//
// What bounds them on an H100: both do a few dozen operations per 12-byte voxel, far
// under the card's ridge, so they are bound by bytes: the sums read 12 bytes per voxel
// (f32 logits and mask), the grads 12 and write 8. The design reads each input once.
// The sums kernel gives every block a fixed, grid-strided share of the voxels; a
// block sums its loss in f32 and its three counts in 64-bit integers (exact for any V)
// and writes one partial; a second single-block pass adds the partials in a fixed order
// (the loss in double), so the result is the same on every run: no float atomics.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 1024;

__device__ __forceinline__ float bce(float x, float t) {
  return fmaxf(x, 0.f) - x * t + log1pf(expf(-fabsf(x)));
}

__global__ void __launch_bounds__(THREADS)
bce_dice_partials(const float* __restrict__ logits, const float* __restrict__ gt, long long v,
                  float* __restrict__ loss_part, unsigned long long* __restrict__ count_part) {
  float loss = 0.f;
  unsigned long long inter = 0, gsum = 0, psum = 0;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < v;
       i += (long long)gridDim.x * THREADS) {
    const float l0 = logits[2 * i], l1 = logits[2 * i + 1];
    const float t = gt[i];
    loss += bce(l0, 1.f - t) + bce(l1, t);
    const bool p = l1 > l0, f = t > 0.f;
    inter += p && f;
    gsum += f;
    psum += p;
  }
  // block reduction: within each warp by shuffles, then across the 8 warps
  for (int off = 16; off > 0; off /= 2) {
    loss += __shfl_down_sync(0xffffffffu, loss, off);
    inter += __shfl_down_sync(0xffffffffu, inter, off);
    gsum += __shfl_down_sync(0xffffffffu, gsum, off);
    psum += __shfl_down_sync(0xffffffffu, psum, off);
  }
  __shared__ float sl[THREADS / 32];
  __shared__ unsigned long long sc[3][THREADS / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) {
    sl[warp] = loss;
    sc[0][warp] = inter; sc[1][warp] = gsum; sc[2][warp] = psum;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float l = 0.f;
    unsigned long long c0 = 0, c1 = 0, c2 = 0;
    for (int w = 0; w < THREADS / 32; ++w) {
      l += sl[w];
      c0 += sc[0][w]; c1 += sc[1][w]; c2 += sc[2][w];
    }
    loss_part[blockIdx.x] = l;
    count_part[3 * blockIdx.x] = c0;
    count_part[3 * blockIdx.x + 1] = c1;
    count_part[3 * blockIdx.x + 2] = c2;
  }
}

// One block: out[0..3] = the partials summed in block order.
__global__ void __launch_bounds__(THREADS)
bce_dice_finish(const float* __restrict__ loss_part, const unsigned long long* __restrict__ count_part,
                int blocks, float* __restrict__ out) {
  __shared__ double sl[THREADS];
  __shared__ unsigned long long sc[3][THREADS];
  double l = 0.0;
  unsigned long long c0 = 0, c1 = 0, c2 = 0;
  for (int b = threadIdx.x; b < blocks; b += THREADS) {
    l += loss_part[b];
    c0 += count_part[3 * b]; c1 += count_part[3 * b + 1]; c2 += count_part[3 * b + 2];
  }
  sl[threadIdx.x] = l;
  sc[0][threadIdx.x] = c0; sc[1][threadIdx.x] = c1; sc[2][threadIdx.x] = c2;
  __syncthreads();
  for (int half = THREADS / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) {
      sl[threadIdx.x] += sl[threadIdx.x + half];
      for (int c = 0; c < 3; ++c) sc[c][threadIdx.x] += sc[c][threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    out[0] = (float)sl[0];
    for (int c = 0; c < 3; ++c) out[1 + c] = (float)sc[c][0];
  }
}

__global__ void __launch_bounds__(THREADS)
bce_dice_grads(const float* __restrict__ logits, const float* __restrict__ gt,
               const float* __restrict__ scale, float* __restrict__ d, long long v) {
  const float s = *scale;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < v;
       i += (long long)gridDim.x * THREADS) {
    const float l0 = logits[2 * i], l1 = logits[2 * i + 1];
    const float t = gt[i];
    d[2 * i] = (1.f / (1.f + expf(-l0)) - (1.f - t)) * s;
    d[2 * i + 1] = (1.f / (1.f + expf(-l1)) - t) * s;
  }
}

int blocks_for(long long v) {
  long long b = (v + THREADS * 16 - 1) / (THREADS * 16);
  return (int)(b < 1 ? 1 : (b > MAX_BLOCKS ? MAX_BLOCKS : b));
}

}  // namespace

// Scratch the sums need: a float and three 64-bit counts per block of the first pass.
extern "C" long long bce_dice_workspace_bytes(long long v) {
  return (long long)blocks_for(v) * (4 + 3 * 8);
}

// logits [V, 2] f32, gt [V] f32, out f32 [4], workspace of
// bce_dice_workspace_bytes(V) bytes, 8-byte aligned; all contiguous on `device`.
// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int bce_dice_sums_launch(const float* logits, const float* gt, float* out,
                                    void* workspace, long long v, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (v <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = blocks_for(v);
  auto* counts = static_cast<unsigned long long*>(workspace);
  auto* loss = reinterpret_cast<float*>(counts + 3 * blocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bce_dice_partials<<<blocks, THREADS, 0, st>>>(logits, gt, v, loss, counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bce_dice_finish<<<1, THREADS, 0, st>>>(loss, counts, blocks, out);
  return (int)cudaGetLastError();
}

// logits [V, 2], d [V, 2], gt [V] and scale [1], all f32 and contiguous on `device`. Launches on `stream` without synchronising;
// returns cudaGetLastError().
extern "C" int bce_dice_grads_launch(const float* logits, const float* gt, const float* scale,
                                     float* d, long long v, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (v <= 0) return (int)cudaErrorInvalidValue;
  const long long b = (v + THREADS * 4 - 1) / (THREADS * 4);
  const int blocks = (int)(b > 8192 ? 8192 : b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bce_dice_grads<<<blocks, THREADS, 0, st>>>(logits, gt, scale, d, v);
  return (int)cudaGetLastError();
}
