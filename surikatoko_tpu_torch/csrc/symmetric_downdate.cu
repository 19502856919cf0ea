// Symmetric covariance downdate: out = k k^T o (P - M^T M), exactly symmetric.
//
// Replaces the Pallas TPU kernel surikatoko_tpu/ops/covariance.py:53
// (symmetric_downdate, body _downdate_kernel :32). In the EKF, M = B =
// C^-1 H P is the whitened gain precursor [m = 2K, D] and P the [D,D]
// covariance; the fused frame step's masked downdate
// D1 = P o kk^T - (B o k)^T (B o k) is this product with the keep mask k.
//
// What bounds it: f32 FMA throughput. The lower triangle alone is
// D(D+1)/2 * m FMAs (1.64e10 at the flagship's D = 4621, m = 1536, 0.49 ms
// at 132 SMs x 128 lanes x 1.98 GHz) against ~157 MB of P read, M read and
// output written (0.047 ms at 3.35 TB/s). Hopper's tensor cores have no
// full-f32 mode and TF32 is barred (reduced-precision products lose the
// innovation Cholesky after ~50 chained updates), so this is a SIMT kernel.
//
// What the design does about it:
// * one thread block per LOWER-triangle TILE x TILE output tile, found from
//   blockIdx.x by inverting the triangular numbering: half the FMAs of a
//   full GEMM. TILE is 128 for large D (8x8 register tiles, 64 FMAs per
//   four 16-byte shared loads) and 32 for small D, where 128-wide tiles
//   would leave most SMs idle; the caller picks it from D
//   (ops/covariance.py:downdate_config).
// * each thread's rows are 4 ty .. 4 ty + 3 (and 64 more for TILE = 128),
//   its columns 4 tx .. likewise; a warp spans 4 ty by 8 tx, so an operand
//   read touches 4 or 8 consecutive float4s, broadcast across the warp.
// * the contraction over m runs in panels of KP rows. The two [KP, TILE]
//   column strips of M are staged through a STAGES-deep cp.async ring in
//   dynamic shared memory, committed and waited on by group, so the next
//   panels load while this one computes; one __syncthreads per panel.
// * rows of M start at a * D floats and D = 13 + 6K is odd, so they are not
//   16-byte aligned. At TILE = 128, 4-byte copies were the largest cost
//   after the FMAs, so a first small kernel copies M into a [m, Dp] scratch
//   (Dp = D rounded up to 4, zero columns past D) and the strips load from
//   it in 16-byte cp.async.cg copies, faster by about a tenth at the
//   flagship shape, the copy included. A call at TILE = 128 is thus two
//   launches. The small tiles, whose launches are short and
//   host-bound, load M directly in 4-byte copies (coalesced across the
//   warp) and skip the extra launch. src-size 0 zero-fills past the D and m
//   edges.
// * summation order: one f32 accumulator per output, from 0, fmaf over
//   a = 0 .. m-1 in increasing order, then (P_ij - acc) k_i k_j; rows past m
//   are zero-filled and add fmaf(0, 0, acc) = acc up to m rounded up to 16
//   (the second half of a 32-row panel runs only below that). No split-K,
//   no atomics: the output repeats bit for bit from run to run, and equals
//   the earlier 16-row-panel kernel's.
// * the epilogue reuses the ring as a padded [TILE][TILE + 1] tile: the
//   accumulators go in, then coalesced passes read P's lower half, apply
//   the keep mask, store (i, j) and, from the same values, the mirror
//   (j, i); a diagonal tile writes its lower half and mirrors it. The
//   output is bitwise symmetric by construction.
// * the keep mask k (0/1 entries: the fused step's) is applied in the
//   epilogue, not on M: for k in {0, 1}, k_i k_j (P_ij - sum_a M_ai M_aj)
//   equals P_ij k_i k_j - sum_a (M_ai k_i)(M_aj k_j) exactly.
// The kernel allocates nothing and never synchronises; the entry point
// returns a cudaError_t (0 = launched).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int KP = 32;       // rows of M per panel
constexpr int STAGES = 3;    // panels in the cp.async ring
constexpr int EPI_LOADS = 4; // loads of P in flight per thread in the epilogue

template <int TILE>
struct Cfg {
  static constexpr int H = TILE >= 128 ? 2 : 1;     // row groups of 4 per thread
  static constexpr int RT = 4 * H;                  // register tile edge
  static constexpr int TS = TILE / RT;              // threads along a tile edge
  static constexpr int THREADS = TS * TS;
  static constexpr int HALF = TILE / H;             // offset between row groups
  static constexpr bool PADDED = TILE >= 128;       // loads from the scratch
  static constexpr int VEC = PADDED ? 4 : 1;        // floats per copy
  static constexpr int STRIP = KP * TILE;           // floats per strip
  static constexpr int ROW_CHUNKS = TILE / VEC;     // copies per strip row
  static constexpr int ROW_STEP = THREADS / ROW_CHUNKS;  // strip rows per pass
  static constexpr int LOADS = STRIP / VEC / THREADS;    // passes per strip
  static constexpr int RING = STAGES * 2 * STRIP * 4;
  static constexpr int EPI = TILE * (TILE + 1) * 4;
  static constexpr int SMEM = RING > EPI ? RING : EPI;
  static constexpr int MIN_BLOCKS = TILE >= 128 ? 2 : 4;
  static_assert(TS % 8 == 0 && THREADS % ROW_CHUNKS == 0, "layout");
  static_assert(TILE * TILE % (EPI_LOADS * THREADS) == 0, "epilogue passes");
};

template <int VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool valid) {
  const unsigned int d = (unsigned int)__cvta_generic_to_shared(dst);
  if constexpr (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 4 : 0));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Mp [m, Dp] = M [m, D] with zero columns D .. Dp-1; one block per row.
__global__ void pad_rows(const float* __restrict__ M, float* __restrict__ Mp,
                         int D, int Dp) {
  const size_t k = blockIdx.x;
  for (int c = threadIdx.x; c < Dp; c += blockDim.x)
    Mp[k * Dp + c] = c < D ? M[k * D + c] : 0.f;
}

template <int TILE, bool HAS_KEEP>
__global__ void __launch_bounds__(Cfg<TILE>::THREADS, Cfg<TILE>::MIN_BLOCKS)
downdate_kernel(const float* __restrict__ P, const float* __restrict__ Ms,
                const float* __restrict__ keep, float* __restrict__ out,
                int D, int ld, int m) {
  using C = Cfg<TILE>;
  extern __shared__ __align__(16) float smem[];

  // lower-triangle tile (bi >= bj): blockIdx.x = bi (bi + 1) / 2 + bj
  const long long t = blockIdx.x;
  long long bi = (long long)((sqrt(8.0 * (double)t + 1.0) - 1.0) * 0.5);
  while (bi * (bi + 1) / 2 > t) --bi;
  while ((bi + 1) * (bi + 2) / 2 <= t) ++bi;
  const long long bj = t - bi * (bi + 1) / 2;
  const int i0 = (int)bi * TILE;
  const int j0 = (int)bj * TILE;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int tx = (warp % (C::TS / 8)) * 8 + lane % 8;   // columns 4 tx ..
  const int ty = (warp / (C::TS / 8)) * 4 + lane / 8;   // rows    4 ty ..

  // M's rows, ld floats apart (D, or Dp in the scratch); this thread's
  // copies: strip columns col .. col + VEC - 1, rows row0 + ROW_STEP r (a
  // copy lies wholly inside or outside [0, ld))
  const int col = C::VEC * (tid % C::ROW_CHUNKS);
  const int row0 = tid / C::ROW_CHUNKS;
  const bool ok_i = i0 + col < ld;
  const bool ok_j = j0 + col < ld;
  const float* src_i = Ms + (ok_i ? i0 + col : 0);
  const float* src_j = Ms + (ok_j ? j0 + col : 0);
  const int n_panels = (m + KP - 1) / KP;

  auto load_panel = [&](int panel) {
    float* si = smem + (panel % STAGES) * 2 * C::STRIP;
    float* sj = si + C::STRIP;
#pragma unroll
    for (int r = 0; r < C::LOADS; ++r) {
      const int row = row0 + r * C::ROW_STEP;
      const int k = panel * KP + row;
      const size_t off = k < m ? (size_t)k * (size_t)ld : 0;
      cp_async<C::VEC>(si + row * TILE + col, src_i + off, k < m && ok_i);
      cp_async<C::VEC>(sj + row * TILE + col, src_j + off, k < m && ok_j);
    }
  };

  float acc[C::RT][C::RT];
#pragma unroll
  for (int p = 0; p < C::RT; ++p)
#pragma unroll
    for (int q = 0; q < C::RT; ++q) acc[p][q] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_panels) load_panel(s);
    cp_async_commit();
  }
  for (int panel = 0; panel < n_panels; ++panel) {
    // panel's group has landed for every thread, and every thread is done
    // with the stage the next load overwrites (panel - 1's)
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (panel + STAGES - 1 < n_panels) load_panel(panel + STAGES - 1);
    cp_async_commit();
    const float* si = smem + (panel % STAGES) * 2 * C::STRIP;
    const float* sj = si + C::STRIP;
    // rows past m rounded up to 16 are skipped (see the summation order)
    const bool second_half = panel * KP + KP / 2 < m;
#pragma unroll
    for (int kk = 0; kk < KP; ++kk) {
      if (kk == KP / 2 && !second_half) break;
      float a[C::RT], b[C::RT];
#pragma unroll
      for (int h = 0; h < C::H; ++h) {
        const float4 va =
            *reinterpret_cast<const float4*>(si + kk * TILE + h * C::HALF + 4 * ty);
        const float4 vb =
            *reinterpret_cast<const float4*>(sj + kk * TILE + h * C::HALF + 4 * tx);
        a[4 * h] = va.x; a[4 * h + 1] = va.y; a[4 * h + 2] = va.z; a[4 * h + 3] = va.w;
        b[4 * h] = vb.x; b[4 * h + 1] = vb.y; b[4 * h + 2] = vb.z; b[4 * h + 3] = vb.w;
      }
#pragma unroll
      for (int p = 0; p < C::RT; ++p)
#pragma unroll
        for (int q = 0; q < C::RT; ++q) acc[p][q] = fmaf(a[p], b[q], acc[p][q]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: it becomes the epilogue tile

  float* tile = smem;   // [TILE][TILE + 1]
#pragma unroll
  for (int p = 0; p < C::RT; ++p) {
    const int r = (p / 4) * C::HALF + 4 * ty + p % 4;
#pragma unroll
    for (int q = 0; q < C::RT; ++q) {
      const int c = (q / 4) * C::HALF + 4 * tx + q % 4;
      tile[r * (TILE + 1) + c] = acc[p][q];
    }
  }
  __syncthreads();

  const bool diag = (bi == bj);
  // (i, j): consecutive threads on consecutive j; k_i k_j (P_ij - acc), with
  // only the lower half of P read, EPI_LOADS of its loads in flight a thread
  for (int e0 = tid; e0 < TILE * TILE; e0 += EPI_LOADS * C::THREADS) {
    float pv[EPI_LOADS], kv[EPI_LOADS];
#pragma unroll
    for (int u = 0; u < EPI_LOADS; ++u) {
      const int e = e0 + u * C::THREADS;
      const int i = i0 + e / TILE, j = j0 + e % TILE;
      const bool ok = i < D && j < D && (!diag || i >= j);
      pv[u] = ok ? P[(size_t)i * D + j] : 0.f;
      if (HAS_KEEP) kv[u] = ok ? keep[i] * keep[j] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < EPI_LOADS; ++u) {
      const int e = e0 + u * C::THREADS;
      const int r = e / TILE, c = e % TILE;
      const int i = i0 + r, j = j0 + c;
      if (i < D && j < D && (!diag || i >= j)) {
        float v = pv[u] - tile[r * (TILE + 1) + c];
        if (HAS_KEEP) v *= kv[u];
        tile[r * (TILE + 1) + c] = v;
        out[(size_t)i * D + j] = v;
      }
    }
  }
  __syncthreads();
  // its mirror (j, i): consecutive threads on consecutive i
  for (int e = tid; e < TILE * TILE; e += C::THREADS) {
    const int c = e / TILE, r = e % TILE;
    const int i = i0 + r, j = j0 + c;
    if (i < D && j < D && (!diag || i > j))
      out[(size_t)j * D + i] = tile[r * (TILE + 1) + c];
  }
}

// The shared-memory attributes of one kernel, set once per device.
template <int TILE, bool HAS_KEEP>
cudaError_t prepare() {
  static unsigned long long ready = 0;   // one bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && (ready >> dev & 1ull)) return cudaSuccess;
  auto kernel = downdate_kernel<TILE, HAS_KEEP>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Cfg<TILE>::SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < 64) ready |= 1ull << dev;
  return err;
}

template <int TILE>
int launch(const float* P, const float* M, const float* keep, float* Mp,
           float* out, int D, int m, cudaStream_t stream) {
  using C = Cfg<TILE>;
  if (C::PADDED && Mp == nullptr) return (int)cudaErrorInvalidValue;
  const bool has_keep = keep != nullptr;
  cudaError_t err = has_keep ? prepare<TILE, true>() : prepare<TILE, false>();
  if (err != cudaSuccess) return (int)err;
  int ld = D;
  if (C::PADDED) {
    ld = (D + 3) / 4 * 4;
    pad_rows<<<m, 256, 0, stream>>>(M, Mp, D, ld);
    M = Mp;
  }
  const unsigned int nt = (D + TILE - 1) / TILE;
  auto kernel = has_keep ? downdate_kernel<TILE, true>
                         : downdate_kernel<TILE, false>;
  kernel<<<nt * (nt + 1) / 2, C::THREADS, C::SMEM, stream>>>(P, M, keep, out,
                                                            D, ld, m);
  return (int)cudaGetLastError();
}

}  // namespace

// out = k k^T o (P - M^T M) for P [D,D] (lower triangle read), M [m,D] and
// keep [D] (0/1, or NULL for all ones), all f32 row-major on the device;
// Mp is scratch of m x Dp floats (Dp = D rounded up to 4) for TILE = 128
// (else unused, may be NULL). TILE x TILE output tiles (32 or 128), one
// thread block per lower-triangle tile. Launches on `stream`; returns a
// cudaError_t (0 = launched).
extern "C" int symmetric_downdate_f32(const float* P, const float* M,
                                      const float* keep, float* Mp, float* out,
                                      int D, int m, int tile,
                                      cudaStream_t stream) {
  switch (tile) {
    case 32: return launch<32>(P, M, keep, Mp, out, D, m, stream);
    case 128: return launch<128>(P, M, keep, Mp, out, D, m, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
