// Gated ZNCC surface argmax for the batched NCC template search, on Hopper.
//
// Replaces the Pallas TPU kernel surikatoko_tpu/ops/ncc_pallas.py
// (ncc_surface_argmax_pallas, kernel body _ncc_block_kernel). For each
// landmark k: the ZNCC of its centred T x T template against every one of
// the S x S placements in its P x P search patch (S = P - T + 1),
//   corr = sum (t - mean t) * window / (sqrt(max(ws2 - ws^2 / T^2, 0)) * |t - mean t|)
// with corr = 0 where that denominator is <= 1e-12, then -inf where the gate
// is false, then the max and the first flat index reaching it (jnp.argmax's
// tie-break; an all-false gate gives -inf at index 0). With the neighbour
// output on, it also returns the raw (ungated) surface at the argmax's
// x-1, x+1, y-1, y+1 cells, index-clamped to [0, S*S) (the caller masks the
// cells outside the window).
//
// Design. One thread block per landmark (K = 768 blocks on the main path).
// The patch, the centred template and (with neighbours) the raw surface sit
// in dynamic shared memory: (P^2 + T^2 + S^2) floats, 5.2 KB at P = 29,
// T = S = 15. The block computes the template mean and norm itself; threads
// stride over the S^2 cells, so any S works, and each thread sums its cell's
// T^2 taps (numerator, window sum, window sum of squares) in registers. A
// warp-shuffle argmax finishes the block. The TPU kernel's lanes-last
// [G, P, P, 128] layout and its padding of K to 128 were for the TPU's vector
// lanes and are gone; the patch gather stays outside, as in JAX.
//
// Bound: shared-memory loads. Each cell reads T^2 patch values and T^2
// template values (the latter broadcast across the warp): at T = S = 15 that
// is 225 x 225 x 2 loads of 4 bytes, about 0.4 MB per block and 0.3 GB per
// frame, for three FMAs per pair of loads, so the loads and not the
// arithmetic set the pace. Register tiling (several cells per thread reusing
// each template value) is the next step.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kNoIndex = 0x7fffffff;

__device__ __forceinline__ void argmax_combine(float& v, int& i, float ov,
                                               int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// Sum of v over the block, returned to every thread. red: 32 shared floats.
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // every thread has read red from the previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.f;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  return red[0];
}

template <bool kNeigh>
__global__ void ncc_search_kernel(const float* __restrict__ patches,
                                  const float* __restrict__ templates,
                                  const unsigned char* __restrict__ gate,
                                  float* __restrict__ best_corr,
                                  int* __restrict__ best_idx,
                                  float* __restrict__ neigh, int P, int T) {
  extern __shared__ float smem[];
  __shared__ float red[32];
  __shared__ int red_i[32];
  const int S = P - T + 1;
  const int PP = P * P, TT = T * T, SS = S * S;
  float* sp = smem;         // [P*P] search patch
  float* st = sp + PP;      // [T*T] centred template
  float* ssurf = st + TT;   // [S*S] raw surface (neighbour output only)
  const int k = blockIdx.x;
  const float* pk = patches + static_cast<size_t>(k) * PP;
  const float* tk = templates + static_cast<size_t>(k) * TT;

  for (int i = threadIdx.x; i < PP; i += blockDim.x) sp[i] = pk[i];
  float tsum = 0.f;
  for (int i = threadIdx.x; i < TT; i += blockDim.x) {
    const float v = tk[i];
    st[i] = v;
    tsum += v;
  }
  const float mean = block_sum(tsum, red) / static_cast<float>(TT);
  float tsq = 0.f;
  for (int i = threadIdx.x; i < TT; i += blockDim.x) {
    const float d = st[i] - mean;
    st[i] = d;
    tsq += d * d;
  }
  // block_sum's barriers also publish the centred template and the patch
  const float tssd = sqrtf(block_sum(tsq, red));
  const float inv_n = 1.f / static_cast<float>(TT);

  float bv = -CUDART_INF_F;
  int bi = kNoIndex;
  const unsigned char* gk = gate + static_cast<size_t>(k) * SS;
  for (int c = threadIdx.x; c < SS; c += blockDim.x) {
    const int oy = c / S, ox = c - oy * S;
    const float* prow = sp + oy * P + ox;
    float cp = 0.f, ws = 0.f, ws2 = 0.f;
    for (int i = 0; i < T; ++i) {
      const float* pr = prow + i * P;
      const float* tr = st + i * T;
      for (int j = 0; j < T; ++j) {
        const float v = pr[j];
        cp = fmaf(tr[j], v, cp);
        ws += v;
        ws2 = fmaf(v, v, ws2);
      }
    }
    const float var = fmaxf(ws2 - ws * ws * inv_n, 0.f);
    const float denom = sqrtf(var) * tssd;
    const float raw = denom > 1e-12f ? cp / denom : 0.f;
    if (kNeigh) ssurf[c] = raw;
    argmax_combine(bv, bi, gk[c] ? raw : -CUDART_INF_F, c);
  }

  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, o);
    const int oi = __shfl_down_sync(0xffffffffu, bi, o);
    argmax_combine(bv, bi, ov, oi);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red is free again, and ssurf is complete
  if (lane == 0) {
    red[warp] = bv;
    red_i[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    bv = lane < nw ? red[lane] : -CUDART_INF_F;
    bi = lane < nw ? red_i[lane] : kNoIndex;
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, o);
      const int oi = __shfl_down_sync(0xffffffffu, bi, o);
      argmax_combine(bv, bi, ov, oi);
    }
    if (lane == 0) {
      best_corr[k] = bv;
      best_idx[k] = bi;
      if (kNeigh) {
        const int d[4] = {-1, 1, -S, S};
        for (int o = 0; o < 4; ++o) {
          const int nb = min(max(bi + d[o], 0), SS - 1);
          neigh[static_cast<size_t>(k) * 4 + o] = ssurf[nb];
        }
      }
    }
  }
}

template <bool kNeigh>
cudaError_t launch(const float* patches, const float* templates,
                   const unsigned char* gate, float* best_corr, int* best_idx,
                   float* neigh, int K, int P, int T, cudaStream_t stream) {
  const int S = P - T + 1;
  const int SS = S * S;
  int threads = ((SS + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem = sizeof(float) * static_cast<size_t>(P * P + T * T + SS);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ncc_search_kernel<kNeigh>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  ncc_search_kernel<kNeigh><<<K, threads, smem, stream>>>(
      patches, templates, gate, best_corr, best_idx, neigh, P, T);
  return cudaGetLastError();
}

}  // namespace

// patches [K,P,P] f32, templates [K,T,T] f32, gate [K,S,S] bool (1 byte),
// outputs best_corr [K] f32, best_idx [K] i32 and, if with_neigh, neigh
// [K,4] f32; all contiguous on the current device. Launches on `stream`
// and returns the CUDA error code of the launch (0 = launched).
extern "C" int ncc_surface_argmax_f32(const void* patches,
                                      const void* templates, const void* gate,
                                      void* best_corr, void* best_idx,
                                      void* neigh, int K, int P, int T,
                                      int with_neigh, void* stream) {
  if (K <= 0 || T <= 0 || P < T) return static_cast<int>(cudaErrorInvalidValue);
  const auto* p = static_cast<const float*>(patches);
  const auto* t = static_cast<const float*>(templates);
  const auto* g = static_cast<const unsigned char*>(gate);
  auto* c = static_cast<float*>(best_corr);
  auto* i = static_cast<int*>(best_idx);
  auto* n = static_cast<float*>(neigh);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      with_neigh ? launch<true>(p, t, g, c, i, n, K, P, T, s)
                 : launch<false>(p, t, g, c, i, n, K, P, T, s);
  return static_cast<int>(e);
}
