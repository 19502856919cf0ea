// Symmetric covariance downdate: out = k k^T o (P - M^T M), exactly symmetric.
//
// Replaces the Pallas TPU kernel surikatoko_tpu/ops/covariance.py:53
// (symmetric_downdate, body _downdate_kernel :32). In the EKF, M = B =
// C^-1 H P is the whitened gain precursor [m = 2K, D] and P the [D,D]
// covariance; the fused frame step's masked downdate
// D1 = P o kk^T - (B o k)^T (B o k) is this product with the keep mask k.
//
// What bounds it: f32 FMA throughput. The lower triangle alone is
// D(D+1)/2 * m FMAs (1.6e10 at the flagship's D = 4621, m = 1536) against
// ~2 D^2 * 4 bytes of P read and output written, far above the card's ratio
// of operations to bytes. Hopper's tensor cores have no full-f32 mode and
// TF32 is barred (reduced-precision products lose the innovation Cholesky
// after ~50 chained updates), so this is a SIMT kernel.
//
// What the design does about it:
// * one thread block per LOWER-triangle 64x64 output tile, found from
//   blockIdx.x by inverting the triangular numbering: half the FMAs of a
//   full GEMM, which is the structural gain over cuBLAS;
// * the contraction over m runs in panels of 16 rows; the two [16, 64]
//   column strips of M (contiguous along D, since M is row-major [m, D]) are
//   staged in shared memory with coalesced loads, and each of the 256
//   threads keeps a 4x4 register micro-tile, fed by two 16-byte shared loads
//   per 16 FMAs;
// * the epilogue writes the tile at (i, j) and, through a padded shared
//   tile, its transpose at (j, i) with coalesced stores; a diagonal tile
//   writes its lower half and mirrors it. Both halves come from one computed
//   value, so the output is bitwise symmetric by construction, whatever the
//   summation order. Only the lower triangle of P is read.
// * the keep mask k (0/1 entries: the fused step's) is applied in the
//   epilogue, not on M: for k in {0, 1}, k_i k_j (P_ij - sum_a M_ai M_aj)
//   equals P_ij k_i k_j - sum_a (M_ai k_i)(M_aj k_j) exactly.
// The ragged edges of D and m are masked with zeros. The kernel allocates
// nothing and never synchronises; the entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 64;                 // output tile edge
constexpr int KP = 16;                   // rows of M per panel
constexpr int TPB = 256;                 // threads: 16 x 16, 4 x 4 outputs each
constexpr int LOADS = KP * TILE / TPB;   // panel elements per thread per strip

template <bool HAS_KEEP>
__global__ void __launch_bounds__(TPB)
downdate_kernel(const float* __restrict__ P, const float* __restrict__ M,
                const float* __restrict__ keep, float* __restrict__ out,
                int D, int m) {
  __shared__ __align__(16) float strip_i[KP][TILE];
  __shared__ __align__(16) float strip_j[KP][TILE];
  __shared__ float tile[TILE][TILE + 1];

  // lower-triangle tile (bi >= bj): blockIdx.x = bi (bi + 1) / 2 + bj
  const long long t = blockIdx.x;
  long long bi = (long long)((sqrt(8.0 * (double)t + 1.0) - 1.0) * 0.5);
  while (bi * (bi + 1) / 2 > t) --bi;
  while ((bi + 1) * (bi + 2) / 2 <= t) ++bi;
  const long long bj = t - bi * (bi + 1) / 2;
  const int i0 = (int)bi * TILE;
  const int j0 = (int)bj * TILE;

  const int tid = threadIdx.x;
  const int tx = tid % 16;   // output columns j0 + 4 tx .. +3
  const int ty = tid / 16;   // output rows    i0 + 4 ty .. +3

  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;

  for (int k0 = 0; k0 < m; k0 += KP) {
#pragma unroll
    for (int r = 0; r < LOADS; ++r) {
      const int e = tid + r * TPB;
      const int row = e / TILE;
      const int col = e % TILE;
      const int k = k0 + row;
      const size_t base = (size_t)k * (size_t)D;
      const int ci = i0 + col;
      const int cj = j0 + col;
      strip_i[row][col] = (k < m && ci < D) ? M[base + ci] : 0.f;
      strip_j[row][col] = (k < m && cj < D) ? M[base + cj] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KP; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&strip_i[kk][4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&strip_j[kk][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(av[p], bv[q], acc[p][q]);
    }
    __syncthreads();
  }

  // epilogue into the shared tile: k_i k_j (P_ij - acc), lower half of P only
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int r = 4 * ty + p;
    const int i = i0 + r;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = 4 * tx + q;
      const int j = j0 + c;
      float v = 0.f;
      if (i < D && j < D && i >= j) {
        v = P[(size_t)i * D + j] - acc[p][q];
        if (HAS_KEEP) v *= keep[i] * keep[j];
      }
      tile[r][c] = v;
    }
  }
  __syncthreads();

  const bool diag = (bi == bj);
  // (i, j): consecutive threads on consecutive j
  for (int e = tid; e < TILE * TILE; e += TPB) {
    const int r = e / TILE, c = e % TILE;
    const int i = i0 + r, j = j0 + c;
    if (i < D && j < D && (!diag || i >= j)) out[(size_t)i * D + j] = tile[r][c];
  }
  // its mirror (j, i): consecutive threads on consecutive i
  for (int e = tid; e < TILE * TILE; e += TPB) {
    const int c = e / TILE, r = e % TILE;
    const int i = i0 + r, j = j0 + c;
    if (i < D && j < D && (!diag || i > j)) out[(size_t)j * D + i] = tile[r][c];
  }
}

}  // namespace

// out = k k^T o (P - M^T M) for P [D,D] (lower triangle read), M [m,D] and
// keep [D] (0/1, or NULL for all ones), all f32 row-major on the device.
// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int symmetric_downdate_f32(const float* P, const float* M,
                                      const float* keep, float* out, int D,
                                      int m, cudaStream_t stream) {
  const long long nt = (D + TILE - 1) / TILE;
  const unsigned int blocks = (unsigned int)(nt * (nt + 1) / 2);
  if (keep != nullptr) {
    downdate_kernel<true><<<blocks, TPB, 0, stream>>>(P, M, keep, out, D, m);
  } else {
    downdate_kernel<false><<<blocks, TPB, 0, stream>>>(P, M, keep, out, D, m);
  }
  return (int)cudaGetLastError();
}
