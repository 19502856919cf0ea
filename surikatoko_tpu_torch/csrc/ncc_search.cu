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
// Bound. At the main path's (K, T, S) = (768, 15, 15) the work is 3.9e7
// FMAs on 3.5 MB of input, so the f32 FMA rate bounds it (1.2 us). With
// ~6 landmarks per SM, what holds the kernel back is the instructions the
// busiest scheduler issues (768 warps on 528 schedulers: some take two)
// and the prologue's load phase, which every SM runs at the same time.
//
// Design.
// * A strip of W adjacent cells of one output row per thread (W = 8 or 4).
//   For each template row i the thread loads the patch row oy + i once, as
//   16-byte shared loads into registers (W + 16 values), and each centred
//   template value, a broadcast 16-byte load, feeds W FMAs: 16 FMAs per
//   shared load instruction at W = 8, where one thread per cell did one.
//   Template columns go in groups of 16 (zero-padded), so any T works.
// * Window sums are separable: while the rows stream through, the thread
//   keeps the column sums of p and p^2 over its W + 16 columns in registers
//   (no running sums with subtraction, which would cancel digits of ws2),
//   then sums T of them per cell once.
// * Strips map to lanes row-fastest, and the patch's shared row stride is 4
//   times an odd number, so the 8 lanes of a 16-byte load phase read 8
//   different rows on 8 different bank quads.
// * One warp per landmark, several landmarks per block; no lane spends a
//   landmark's whole loop on one live cell. (Splitting a landmark's template
//   rows over two or three warps, to even the 768 warps out over the 528
//   schedulers, measures no faster on an H100.)
// * Prologue: the template, gate and patch loads of a warp are all in
//   flight at once, through registers (4-byte cp.async ran at a fraction of
//   the rate); the warp forms the template's mean and norm by warp
//   reductions while the patch is still arriving; no block barrier at all.
// * The argmax is taken per strip in cell order and then across lanes with
//   shuffles, the lower index winning ties; the raw surface stays in shared
//   memory for the neighbour output.
// Numerics: the summation order is not the plain version's, and the final
// quotient is __fdividef (2 ulp), so the surface agrees with it to rounding,
// not bit for bit.
// The TPU kernel's lanes-last [G, P, P, 128] layout and its padding of K to
// 128 were for the TPU's vector lanes and are gone; the patch gather stays
// outside, as in JAX.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kGroup = 16;  // template columns per pass over the rows
constexpr int kNoIndex = 0x7fffffff;
// the entry point's choice, from a device-time sweep at (768, 15, 15)
constexpr int kDefaultCells = 8;
constexpr int kDefaultLandmarksPerBlock = 2;

__device__ __forceinline__ void argmax_combine(float& v, int& i, float ov,
                                               int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Slot e of a template zero-padded to [T][TS]: t[i][j], or 0 in the padding.
__device__ __forceinline__ float template_slot(const float* tk, int e, int T,
                                               int TS) {
  const int i = TS == 16 ? e >> 4 : e / TS, j = e - i * TS;
  return (i < T && j < T) ? tk[i * T + j] : 0.f;
}

// Rows r < min(32, rows) and column `lane` (< cols) of a row-major block
// with row pitch `pitch`, to registers and back; zeros outside.
__device__ __forceinline__ void load_rows(const float* src, int pitch,
                                          int rows, int cols, int lane,
                                          float (&pv)[32]) {
#pragma unroll
  for (int r = 0; r < 32; ++r)
    pv[r] = (r < rows && lane < cols) ? src[r * pitch + lane] : 0.f;
}

__device__ __forceinline__ void store_rows(float* dst, int pitch, int rows,
                                           int cols, int lane,
                                           const float (&pv)[32]) {
#pragma unroll
  for (int r = 0; r < 32; ++r)
    if (r < rows && lane < cols) dst[r * pitch + lane] = pv[r];
}

// One template row's centred values and the patch row segment a strip of W
// cells reads for them, in registers.
template <int W>
struct Row {
  float v[kGroup + W], t[kGroup];

  __device__ __forceinline__ void load(const float* prow, const float* trow) {
#pragma unroll
    for (int x = 0; x < kGroup + W; x += 4) {
      const float4 a = *reinterpret_cast<const float4*>(prow + x);
      v[x] = a.x, v[x + 1] = a.y, v[x + 2] = a.z, v[x + 3] = a.w;
    }
#pragma unroll
    for (int j = 0; j < kGroup; j += 4) {
      const float4 a = *reinterpret_cast<const float4*>(trow + j);
      t[j] = a.x, t[j + 1] = a.y, t[j + 2] = a.z, t[j + 3] = a.w;
    }
  }

  // numerator taps of the W cells, and the column sums of p and p^2
  __device__ __forceinline__ void accumulate(float* cp, float* cs,
                                             float* cs2) const {
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
#pragma unroll
      for (int c = 0; c < W; ++c) cp[c] = fmaf(t[j], v[c + j], cp[c]);
#pragma unroll
    for (int x = 0; x < kGroup + W; ++x) {
      cs[x] += v[x];
      cs2[x] = fmaf(v[x], v[x], cs2[x]);
    }
  }
};

// Shared memory of one landmark, in floats: the patch [P][stride], the
// centred template [T][TS] (TS = 16 * groups, zero-padded), the raw surface
// [S*S] (neighbour output only) and the gate [S*S] bytes; each part a
// multiple of 16 bytes.
struct Layout {
  int S, groups, TS, strips_per_row, stride, floats;
};

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

__host__ __device__ inline Layout make_layout(int P, int T, int W, bool neigh) {
  Layout L;
  L.S = P - T + 1;
  L.groups = (T + kGroup - 1) / kGroup;
  L.TS = L.groups * kGroup;
  L.strips_per_row = (L.S + W - 1) / W;
  // the last strip's last group reads up to column strips*W + TS - 1 (> P)
  int quads = (L.strips_per_row * W + L.TS + 3) / 4;
  if (quads % 2 == 0) ++quads;  // odd: 8 consecutive rows hit 8 bank quads
  L.stride = 4 * quads;
  const int SS = L.S * L.S;
  L.floats = P * L.stride + T * L.TS + (neigh ? round4(SS) : 0) +
             round4((SS + 3) / 4);
  return L;
}

template <int W, bool kNeigh>
__global__ void ncc_search_kernel(const float* __restrict__ patches,
                                  const float* __restrict__ templates,
                                  const unsigned char* __restrict__ gate,
                                  float* __restrict__ best_corr,
                                  int* __restrict__ best_idx,
                                  float* __restrict__ neigh, int K, int P,
                                  int T) {
  extern __shared__ float4 smem4[];
  const Layout L = make_layout(P, T, W, kNeigh);
  const int S = L.S, SS = S * S, TT = T * T;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = blockIdx.x * (blockDim.x >> 5) + warp;
  if (k >= K) return;  // the ragged last block; no block barrier follows
  float* sp = reinterpret_cast<float*>(smem4) + warp * L.floats;
  float* st = sp + P * L.stride;
  float* ssurf = st + T * L.TS;
  unsigned char* sg =
      reinterpret_cast<unsigned char*>(ssurf + (kNeigh ? round4(SS) : 0));
  const float* pk = patches + static_cast<size_t>(k) * P * P;
  const float* tk = templates + static_cast<size_t>(k) * TT;
  const unsigned char* gk = gate + static_cast<size_t>(k) * SS;

  // ---- prologue: template, gate and patch loads all in flight at once,
  // into registers; the template's mean and norm by warp reductions while
  // the patch is still arriving; then the patch into padded rows ----
  // template slots e of the padded [T][TS] grid, eight per lane and batch;
  // the first batch stays in registers
  const int slots = T * L.TS;
  float tv[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) tv[r] = template_slot(tk, lane + 32 * r, T, L.TS);
  unsigned char gv[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) gv[r] = lane + 32 * r < SS ? gk[lane + 32 * r] : 0;
  // the patch: 32 rows of a 32-column chunk a batch; the columns from P to
  // the last one a strip reads become zeros (the zero taps of the padded
  // template multiply them)
  const int width = L.strips_per_row * W + L.TS;
  float pv[32];
  load_rows(pk, P, P, P, lane, pv);
  float s = 0.f;
#pragma unroll
  for (int r = 0; r < 8; ++r) s += tv[r];
  for (int e = 256 + lane; e < slots; e += 32) s += template_slot(tk, e, T, L.TS);
  const float mean = warp_sum(s) / static_cast<float>(TT);
  float q = 0.f;
  for (int e0 = 0; e0 < slots; e0 += 256) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int e = e0 + lane + 32 * r;
      const int i = L.TS == 16 ? e >> 4 : e / L.TS, j = e - i * L.TS;
      const bool in = i < T && j < T;
      const float v = e0 == 0 ? tv[r] : template_slot(tk, e, T, L.TS);
      const float d = in ? v - mean : 0.f;
      q += d * d;
      if (e < slots) st[e] = d;
    }
  }
  const float tssd = sqrtf(warp_sum(q));
  store_rows(sp, L.stride, P, width, lane, pv);
  for (int x0 = 0; x0 < width; x0 += 32)
    for (int y0 = 0; y0 < P; y0 += 32) {
      if (x0 == 0 && y0 == 0) continue;  // the first batch, done above
      load_rows(pk + y0 * P + x0, P, P - y0, P - x0, lane, pv);
      store_rows(sp + y0 * L.stride + x0, L.stride, P - y0, width - x0, lane, pv);
    }
#pragma unroll
  for (int r = 0; r < 8; ++r)
    if (lane + 32 * r < SS) sg[lane + 32 * r] = gv[r];
  for (int e = lane + 256; e < SS; e += 32) sg[e] = gk[e];
  __syncwarp();

  // ---- strips of W cells: numerator, column sums, then the cells ----
  float bv = -CUDART_INF_F;
  int bi = kNoIndex;
  const float inv_n = 1.f / static_cast<float>(TT);
  for (int strip = lane; strip < S * L.strips_per_row; strip += 32) {
    const int sx = strip / S, oy = strip - sx * S, ox0 = sx * W;
    float cp[W], ws[W], ws2[W];
#pragma unroll
    for (int c = 0; c < W; ++c) cp[c] = ws[c] = ws2[c] = 0.f;
    for (int grp = 0; grp < L.groups; ++grp) {
      float cs[kGroup + W], cs2[kGroup + W];
#pragma unroll
      for (int x = 0; x < kGroup + W; ++x) cs[x] = cs2[x] = 0.f;
      const float* prow = sp + oy * L.stride + ox0 + grp * kGroup;
      const float* trow = st + grp * kGroup;
#pragma unroll 2
      for (int i = 0; i < T; ++i) {
        Row<W> row;
        row.load(prow, trow);
        row.accumulate(cp, cs, cs2);
        prow += L.stride;
        trow += L.TS;
      }
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        if (grp * kGroup + j >= T) break;
#pragma unroll
        for (int c = 0; c < W; ++c) {
          ws[c] += cs[c + j];
          ws2[c] += cs2[c + j];
        }
      }
    }
#pragma unroll
    for (int c = 0; c < W; ++c) {
      if (ox0 + c >= S) break;
      const float var = fmaxf(ws2[c] - ws[c] * ws[c] * inv_n, 0.f);
      const float denom = sqrtf(var) * tssd;
      const float raw = denom > 1e-12f ? __fdividef(cp[c], denom) : 0.f;
      const int cell = oy * S + ox0 + c;
      if (kNeigh) ssurf[cell] = raw;
      argmax_combine(bv, bi, sg[cell] ? raw : -CUDART_INF_F, cell);
    }
  }

  // ---- argmax across the lanes, then the landmark's outputs ----
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, o);
    const int oi = __shfl_down_sync(0xffffffffu, bi, o);
    argmax_combine(bv, bi, ov, oi);
  }
  __syncwarp();  // ssurf complete
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

template <int W, bool kNeigh>
cudaError_t launch(const float* patches, const float* templates,
                   const unsigned char* gate, float* best_corr, int* best_idx,
                   float* neigh, int K, int P, int T, int lms_per_block,
                   cudaStream_t stream) {
  if (lms_per_block < 1 || lms_per_block > 32) return cudaErrorInvalidValue;
  const Layout L = make_layout(P, T, W, kNeigh);
  const size_t smem = sizeof(float) * static_cast<size_t>(lms_per_block) * L.floats;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ncc_search_kernel<W, kNeigh>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (K + lms_per_block - 1) / lms_per_block;
  ncc_search_kernel<W, kNeigh><<<blocks, 32 * lms_per_block, smem, stream>>>(
      patches, templates, gate, best_corr, best_idx, neigh, K, P, T);
  return cudaGetLastError();
}

template <bool kNeigh>
cudaError_t launch_cells(int cells, const float* p, const float* t,
                         const unsigned char* g, float* c, int* i, float* n,
                         int K, int P, int T, int lpb, cudaStream_t s) {
  switch (cells) {
    case 4: return launch<4, kNeigh>(p, t, g, c, i, n, K, P, T, lpb, s);
    case 8: return launch<8, kNeigh>(p, t, g, c, i, n, K, P, T, lpb, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// As ncc_surface_argmax_f32, with the tiling chosen by the caller: cells
// per thread (4 or 8) and landmarks (warps) per block.
extern "C" int ncc_surface_argmax_tiled_f32(
    const void* patches, const void* templates, const void* gate,
    void* best_corr, void* best_idx, void* neigh, int K, int P, int T,
    int with_neigh, int cells_per_thread, int lms_per_block, void* stream) {
  if (K <= 0 || T <= 0 || P < T) return static_cast<int>(cudaErrorInvalidValue);
  const auto* p = static_cast<const float*>(patches);
  const auto* t = static_cast<const float*>(templates);
  const auto* g = static_cast<const unsigned char*>(gate);
  auto* c = static_cast<float*>(best_corr);
  auto* i = static_cast<int*>(best_idx);
  auto* n = static_cast<float*>(neigh);
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      with_neigh ? launch_cells<true>(cells_per_thread, p, t, g, c, i, n, K, P,
                                      T, lms_per_block, s)
                 : launch_cells<false>(cells_per_thread, p, t, g, c, i, n, K,
                                       P, T, lms_per_block, s);
  return static_cast<int>(e);
}

// patches [K,P,P] f32, templates [K,T,T] f32, gate [K,S,S] bool (1 byte),
// outputs best_corr [K] f32, best_idx [K] i32 and, if with_neigh, neigh
// [K,4] f32; all contiguous on the current device. Launches on `stream`
// and returns the CUDA error code of the launch (0 = launched).
extern "C" int ncc_surface_argmax_f32(const void* patches,
                                      const void* templates, const void* gate,
                                      void* best_corr, void* best_idx,
                                      void* neigh, int K, int P, int T,
                                      int with_neigh, void* stream) {
  return ncc_surface_argmax_tiled_f32(
      patches, templates, gate, best_corr, best_idx, neigh, K, P, T,
      with_neigh, kDefaultCells, kDefaultLandmarksPerBlock, stream);
}
