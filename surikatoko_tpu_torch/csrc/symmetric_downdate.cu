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
// * a batch of B problems of one shape is one launch: blockIdx.y picks the
//   problem, each block computes exactly what it would alone (the same
//   tile, loads, summation order and epilogue), so every problem's output
//   equals its unbatched call's bit for bit. torch.func.vmap of the port's
//   filter step reaches the batched entry points (ops/covariance.py).
// The kernel allocates nothing and never synchronises; the entry points
// return a cudaError_t (0 = launched).
//
// The float64 entry point (symmetric_downdate_f64). What bounds it: FP64
// FMAs, D(D+1)/2 m at the FP64 tensor cores' 132 SMs x 128 FMA a clock x
// 1.98 GHz (33.5 TFMA/s), 0.49 ms at D = 4621, m = 1536 against 0.093 ms
// for its 313 MB. The FP64 vector lanes run half that rate, and wgmma has
// no f64 form, so every float64 call runs on the FP64 tensor cores through
// mma.sync (DMMA), in a kernel of its own (downdate_kernel_dmma). At the
// flagship shape it reaches about half that bound; PERF.md says what holds
// the rest.
// * 64 x 64 lower-triangle tiles, one block each, 4 warps of 32 x 32 warp
//   tiles, each 2 x 4 m16n8k16 MMAs (32 accumulators of two registers);
//   three blocks share an SM (68 KB of shared memory each). In a sweep on
//   an H100 (tools/probe_downdate.py) these beat 128-wide tiles (8 warps of
//   64 x 32, one block an SM for registers) at every D, k16 beat k4 and
//   k8, and 16-row panels beat 32-row ones.
// * C_ij = sum_a M_ai M_aj: both operands are column strips of M, staged
//   k-major as [16, 64] (one MMA deep) through a 4-deep ring of 8-byte
//   cp.async copies straight from M (src-size 0 zero-fills past D and m).
//   Rows of M start at a D doubles, D odd, so 16-byte copies would need
//   the padded copy the float32 tiles use; in float64 that copy cost more
//   than it saved at every D in the sweep. ldmatrix has no 64-bit form: the
//   fragments come from plain 8-byte shared loads, and a strip row is 68
//   doubles long, so the 16 lanes of a half-warp (4 rows k x 4 columns)
//   hit 16 distinct bank pairs: no conflicts.
// * summation order: one accumulator per output from 0, one MMA a panel of
//   16 rows of M in increasing order (rows past m are zero); no split-K,
//   no atomics, so two launches give equal bits. Within an MMA the order is
//   the tensor core's, so the outputs may differ from a sequential fma
//   chain's in the last bits (they are held to the plain version at 1e-12).
// * the epilogue is the float32 kernel's (write_tile): keep mask and
//   P_ij - acc applied, the mirror through the padded shared tile, so the
//   output is bitwise symmetric.
// * one tile edge at every D. At D <= 397, where a call lasts 5-11 us, the
//   earlier float64 kernel (the float32 one in double, 32-wide tiles on the
//   vector lanes) ran 2-3 us faster, but no float64 path runs there.

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
};

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const unsigned int d = (unsigned int)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 16 : 0));
  } else if constexpr (BYTES == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 8 : 0));
  } else {
    static_assert(BYTES == 4, "copy size");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(valid ? 4 : 0));
  }
}

// four consecutive values from shared memory (16-byte aligned)
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Mp [m, Dp] = M [m, D] with zero columns D .. Dp-1; one block per row,
// blockIdx.y the problem of a batch (M and Mp offset by sM and sMp floats).
__global__ void pad_rows(const float* __restrict__ M, float* __restrict__ Mp,
                         int D, int Dp, long long sM, long long sMp) {
  const size_t k = blockIdx.x;
  M += blockIdx.y * sM;
  Mp += blockIdx.y * sMp;
  for (int c = threadIdx.x; c < Dp; c += blockDim.x)
    Mp[k * Dp + c] = c < D ? M[k * D + c] : 0.f;
}

// lower-triangle tile (bi >= bj) of block t = bi (bi + 1) / 2 + bj
__device__ __forceinline__ void tile_of_block(long long t, long long& bi,
                                              long long& bj) {
  bi = (long long)((sqrt(8.0 * (double)t + 1.0) - 1.0) * 0.5);
  while (bi * (bi + 1) / 2 > t) --bi;
  while ((bi + 1) * (bi + 2) / 2 <= t) ++bi;
  bj = t - bi * (bi + 1) / 2;
}

// The epilogue of both kernels. `tile` [TILE][TILE + 1] in shared memory
// holds the block's accumulators (the caller synchronised after writing
// them): (i, j) = k_i k_j (P_ij - acc), consecutive threads on consecutive
// j, only the lower half of P read, EPI_LOADS of its loads in flight a
// thread; then from the same values its mirror (j, i), consecutive threads
// on consecutive i. A diagonal tile writes its lower half and mirrors it.
template <int TILE, int THREADS, bool HAS_KEEP, typename T>
__device__ __forceinline__ void write_tile(T* tile, const T* __restrict__ P,
                                           const T* __restrict__ keep,
                                           T* __restrict__ out, int D, int i0,
                                           int j0, bool diag, int tid) {
  static_assert(TILE * TILE % (EPI_LOADS * THREADS) == 0, "epilogue passes");
  for (int e0 = tid; e0 < TILE * TILE; e0 += EPI_LOADS * THREADS) {
    T pv[EPI_LOADS], kv[EPI_LOADS];
#pragma unroll
    for (int u = 0; u < EPI_LOADS; ++u) {
      const int e = e0 + u * THREADS;
      const int i = i0 + e / TILE, j = j0 + e % TILE;
      const bool ok = i < D && j < D && (!diag || i >= j);
      pv[u] = ok ? P[(size_t)i * D + j] : T(0);
      if (HAS_KEEP) kv[u] = ok ? keep[i] * keep[j] : T(0);
    }
#pragma unroll
    for (int u = 0; u < EPI_LOADS; ++u) {
      const int e = e0 + u * THREADS;
      const int r = e / TILE, c = e % TILE;
      const int i = i0 + r, j = j0 + c;
      if (i < D && j < D && (!diag || i >= j)) {
        T v = pv[u] - tile[r * (TILE + 1) + c];
        if (HAS_KEEP) v *= kv[u];
        tile[r * (TILE + 1) + c] = v;
        out[(size_t)i * D + j] = v;
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < TILE * TILE; e += THREADS) {
    const int c = e / TILE, r = e % TILE;
    const int i = i0 + r, j = j0 + c;
    if (i < D && j < D && (!diag || i > j))
      out[(size_t)j * D + i] = tile[r * (TILE + 1) + c];
  }
}

// blockIdx.x: the output tile. BATCHED: blockIdx.y is the problem of a
// batch, whose P, M (rows ld floats apart) and keep start sP, sM and sK
// floats on (0 for one shared by every problem) and whose output starts
// b D^2 floats on; a single problem takes the kernel without that
// addressing (on an H100 it cost the flagship shape's call 4% of its
// device time)
template <int TILE, bool HAS_KEEP, bool BATCHED>
__global__ void __launch_bounds__(Cfg<TILE>::THREADS, Cfg<TILE>::MIN_BLOCKS)
downdate_kernel(const float* __restrict__ P, const float* __restrict__ Ms,
                const float* __restrict__ keep, float* __restrict__ out,
                int D, int ld, int m, long long sP, long long sM,
                long long sK) {
  using C = Cfg<TILE>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  if constexpr (BATCHED) {
    const long long b = blockIdx.y;
    P += b * sP;
    Ms += b * sM;
    if (HAS_KEEP) keep += b * sK;
    out += b * (long long)D * D;
  }

  long long bi, bj;
  tile_of_block(blockIdx.x, bi, bj);
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
      constexpr int BYTES = C::VEC * 4;
      cp_async<BYTES>(si + row * TILE + col, src_i + off, k < m && ok_i);
      cp_async<BYTES>(sj + row * TILE + col, src_j + off, k < m && ok_j);
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
        load4(si + kk * TILE + h * C::HALF + 4 * ty, a + 4 * h);
        load4(sj + kk * TILE + h * C::HALF + 4 * tx, b + 4 * h);
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
  write_tile<TILE, C::THREADS, HAS_KEEP>(tile, P, keep, out, D, i0, j0,
                                         bi == bj, tid);
}

// ---- float64 on the FP64 tensor cores ----

// 64 x 64 output tiles, 4 warps, each a 32 x 32 warp tile of 2 x 4
// m16n8k16 MMAs; one panel of M's rows is one MMA deep
struct Cfg64 {
  static constexpr int TILE = 64;
  static constexpr int KP = 16;                      // rows of M per panel
  static constexpr int STAGES = 4;                   // panels in the ring
  static constexpr int WARPS_N = 2;                  // warps across; 2 down
  static constexpr int WM = 32, WN = 32;             // warp tile
  static constexpr int MI = WM / 16, NI = WN / 8;    // m16n8 MMA tiles a warp
  static constexpr int THREADS = 128;
  static constexpr int LD = TILE + 4;                // strip row, in doubles
  static constexpr int STRIP = KP * LD;
  static constexpr int ROW_STEP = THREADS / TILE;   // strip rows a pass
  static constexpr int LOADS = KP / ROW_STEP;        // copies a thread a strip
  static constexpr int RING = STAGES * 2 * STRIP * (int)sizeof(double);
  static constexpr int EPI = TILE * (TILE + 1) * (int)sizeof(double);
  static constexpr int SMEM = RING > EPI ? RING : EPI;
  static constexpr int MIN_BLOCKS = 3;               // 3 x 68 KB of shared
  static_assert(KP % ROW_STEP == 0 && LD % 16 == 4, "layout");
};

// c += a b on the FP64 tensor cores: one m16n8k16 MMA. Fragments (g = lane
// / 4, t = lane % 4): a[i] = A(g + 8 (i % 2), t + 4 (i / 2)), b[i] = B(t +
// 4 i, g), c[v] = C(g + 8 (v / 2), 2 t + v % 2).
__device__ __forceinline__ void dmma(double (&c)[4], const double (&a)[8],
                                     const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]),
        "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// A = M's column strip i0.., B = its strip j0..; C = A^T B accumulates in
// registers
// the batch axis (BATCHED) as in downdate_kernel
template <bool HAS_KEEP, bool BATCHED>
__global__ void __launch_bounds__(Cfg64::THREADS, Cfg64::MIN_BLOCKS)
downdate_kernel_dmma(const double* __restrict__ P, const double* __restrict__ M,
                     const double* __restrict__ keep, double* __restrict__ out,
                     int D, int m, long long sP, long long sM, long long sK) {
  using C = Cfg64;
  constexpr int TILE = C::TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* smem = reinterpret_cast<double*>(smem_raw);
  if constexpr (BATCHED) {
    const long long b = blockIdx.y;
    P += b * sP;
    M += b * sM;
    if (HAS_KEEP) keep += b * sK;
    out += b * (long long)D * D;
  }

  long long bi, bj;
  tile_of_block(blockIdx.x, bi, bj);
  const int i0 = (int)bi * TILE;
  const int j0 = (int)bj * TILE;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = (warp / C::WARPS_N) * C::WM;   // the warp tile's first row
  const int wc = (warp % C::WARPS_N) * C::WN;   // and column

  // this thread's copies: strip column col, rows row0 + ROW_STEP r
  const int col = tid % TILE;
  const int row0 = tid / TILE;
  const bool ok_i = i0 + col < D;
  const bool ok_j = j0 + col < D;
  const double* src_i = M + (ok_i ? i0 + col : 0);
  const double* src_j = M + (ok_j ? j0 + col : 0);
  const int n_panels = (m + C::KP - 1) / C::KP;

  auto load_panel = [&](int panel) {
    double* si = smem + (panel % C::STAGES) * 2 * C::STRIP;
    double* sj = si + C::STRIP;
#pragma unroll
    for (int r = 0; r < C::LOADS; ++r) {
      const int row = row0 + r * C::ROW_STEP;
      const int k = panel * C::KP + row;
      const size_t off = k < m ? (size_t)k * (size_t)D : 0;
      cp_async<8>(si + row * C::LD + col, src_i + off, k < m && ok_i);
      cp_async<8>(sj + row * C::LD + col, src_j + off, k < m && ok_j);
    }
  };

  double acc[C::MI][C::NI][4];
#pragma unroll
  for (int p = 0; p < C::MI; ++p)
#pragma unroll
    for (int q = 0; q < C::NI; ++q)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[p][q][v] = 0.0;

#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < n_panels) load_panel(s);
    cp_async_commit();
  }
  for (int panel = 0; panel < n_panels; ++panel) {
    // panel's group has landed for every thread, and every thread is done
    // with the stage the next load overwrites (panel - 1's)
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();
    if (panel + C::STAGES - 1 < n_panels) load_panel(panel + C::STAGES - 1);
    cp_async_commit();
    const double* si = smem + (panel % C::STAGES) * 2 * C::STRIP + wr + g;
    const double* sj = si - wr + C::STRIP + wc;
    double a[C::MI][8], b[C::NI][4];
#pragma unroll
    for (int p = 0; p < C::MI; ++p)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[p][i] = si[(t + 4 * (i / 2)) * C::LD + 16 * p + 8 * (i % 2)];
#pragma unroll
    for (int q = 0; q < C::NI; ++q)
#pragma unroll
      for (int i = 0; i < 4; ++i) b[q][i] = sj[(t + 4 * i) * C::LD + 8 * q];
#pragma unroll
    for (int p = 0; p < C::MI; ++p)
#pragma unroll
      for (int q = 0; q < C::NI; ++q) dmma(acc[p][q], a[p], b[q]);
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: it becomes the epilogue tile

  double* tile = smem;   // [TILE][TILE + 1]
#pragma unroll
  for (int p = 0; p < C::MI; ++p)
#pragma unroll
    for (int q = 0; q < C::NI; ++q)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int r = wr + 16 * p + g + 8 * (v / 2);
        const int c = wc + 8 * q + 2 * t + v % 2;
        tile[r * (TILE + 1) + c] = acc[p][q][v];
      }
  __syncthreads();
  write_tile<TILE, C::THREADS, HAS_KEEP>(tile, P, keep, out, D, i0, j0,
                                         bi == bj, tid);
}

// The shared-memory attributes of `kernel`, set once per device: `ready`
// holds one bit per device, one variable per kernel.
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int smem, unsigned long long& ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && (ready >> dev & 1ull)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < 64) ready |= 1ull << dev;
  return err;
}

template <int TILE, bool HAS_KEEP, bool BATCHED>
cudaError_t prepare() {
  static unsigned long long ready = 0;
  return set_smem(downdate_kernel<TILE, HAS_KEEP, BATCHED>, Cfg<TILE>::SMEM,
                  ready);
}

template <bool HAS_KEEP, bool BATCHED>
cudaError_t prepare_dmma() {
  static unsigned long long ready = 0;
  return set_smem(downdate_kernel_dmma<HAS_KEEP, BATCHED>, Cfg64::SMEM, ready);
}

// the kernel of a launch: with or without the keep mask, and with the
// batch addressing when there is more than one problem
template <int TILE>
decltype(&downdate_kernel<TILE, false, false>) pick(bool has_keep,
                                                    bool batched,
                                                    cudaError_t& err) {
  if (has_keep) {
    if (batched) {
      err = prepare<TILE, true, true>();
      return downdate_kernel<TILE, true, true>;
    }
    err = prepare<TILE, true, false>();
    return downdate_kernel<TILE, true, false>;
  }
  if (batched) {
    err = prepare<TILE, false, true>();
    return downdate_kernel<TILE, false, true>;
  }
  err = prepare<TILE, false, false>();
  return downdate_kernel<TILE, false, false>;
}

decltype(&downdate_kernel_dmma<false, false>) pick_dmma(bool has_keep,
                                                        bool batched,
                                                        cudaError_t& err) {
  if (has_keep) {
    if (batched) {
      err = prepare_dmma<true, true>();
      return downdate_kernel_dmma<true, true>;
    }
    err = prepare_dmma<true, false>();
    return downdate_kernel_dmma<true, false>;
  }
  if (batched) {
    err = prepare_dmma<false, true>();
    return downdate_kernel_dmma<false, true>;
  }
  err = prepare_dmma<false, false>();
  return downdate_kernel_dmma<false, false>;
}

// B problems (1 <= B <= 65535, the grid's y extent); a problem's P, M and
// keep start sP, sM and sK values after the previous one's (0: shared)
bool bad_batch(int B, long long sP, long long sM, long long sK) {
  return B < 1 || B > 65535 || sP < 0 || sM < 0 || sK < 0;
}

template <int TILE>
int launch(const float* P, const float* M, const float* keep, float* Mp,
           float* out, int B, int D, int m, long long sP, long long sM,
           long long sK, cudaStream_t stream) {
  using C = Cfg<TILE>;
  if (C::PADDED && Mp == nullptr) return (int)cudaErrorInvalidValue;
  if (bad_batch(B, sP, sM, sK)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  auto kernel = pick<TILE>(keep != nullptr, B > 1, err);
  if (err != cudaSuccess) return (int)err;
  int ld = D;
  if (C::PADDED) {
    // a shared M is padded once
    ld = (D + 3) / 4 * 4;
    const long long sMp = sM == 0 ? 0 : (long long)m * ld;
    pad_rows<<<dim3(m, sM == 0 ? 1 : B), 256, 0, stream>>>(M, Mp, D, ld, sM,
                                                           sMp);
    M = Mp;
    sM = sMp;
  }
  const unsigned int nt = (D + TILE - 1) / TILE;
  kernel<<<dim3(nt * (nt + 1) / 2, B), C::THREADS, C::SMEM, stream>>>(
      P, M, keep, out, D, ld, m, sP, sM, sK);
  return (int)cudaGetLastError();
}

int launch_dmma(const double* P, const double* M, const double* keep,
                double* out, int B, int D, int m, long long sP, long long sM,
                long long sK, cudaStream_t stream) {
  using C = Cfg64;
  if (bad_batch(B, sP, sM, sK)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  auto kernel = pick_dmma(keep != nullptr, B > 1, err);
  if (err != cudaSuccess) return (int)err;
  const unsigned int nt = (D + C::TILE - 1) / C::TILE;
  kernel<<<dim3(nt * (nt + 1) / 2, B), C::THREADS, C::SMEM, stream>>>(
      P, M, keep, out, D, m, sP, sM, sK);
  return (int)cudaGetLastError();
}

}  // namespace

// out[b] = k_b k_b^T o (P_b - M_b^T M_b) for B problems: P_b [D,D] (lower
// triangle read) at P + b sP, M_b [m,D] at M + b sM and keep_b [D] (0/1, or
// NULL for all ones) at keep + b sK (a stride of 0 shares one tensor between
// the problems), out [B,D,D]; all f32 row-major on the device. Mp is scratch
// of Bp x m x Dp floats (Dp = D rounded up to 4; Bp = 1 if sM = 0, else B)
// for TILE = 128 (else unused, may be NULL). TILE x TILE output tiles (32 or
// 128), one thread block per lower-triangle tile and problem; each problem's
// output is bit for bit that of its own unbatched call. Launches on
// `stream`; returns a cudaError_t (0 = launched).
extern "C" int symmetric_downdate_f32_batched(
    const float* P, const float* M, const float* keep, float* Mp, float* out,
    int B, int D, int m, int tile, long long sP, long long sM, long long sK,
    cudaStream_t stream) {
  switch (tile) {
    case 32:
      return launch<32>(P, M, keep, Mp, out, B, D, m, sP, sM, sK, stream);
    case 128:
      return launch<128>(P, M, keep, Mp, out, B, D, m, sP, sM, sK, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// One problem: P [D,D], M [m,D], keep [D] or NULL, out [D,D]; Mp m x Dp.
extern "C" int symmetric_downdate_f32(const float* P, const float* M,
                                      const float* keep, float* Mp, float* out,
                                      int D, int m, int tile,
                                      cudaStream_t stream) {
  return symmetric_downdate_f32_batched(P, M, keep, Mp, out, 1, D, m, tile, 0,
                                        0, 0, stream);
}

// The same for float64 P, M, keep and out, with no scratch: the DMMA
// kernel's 64 x 64 tiles at every D.
extern "C" int symmetric_downdate_f64_batched(
    const double* P, const double* M, const double* keep, double* out, int B,
    int D, int m, long long sP, long long sM, long long sK,
    cudaStream_t stream) {
  return launch_dmma(P, M, keep, out, B, D, m, sP, sM, sK, stream);
}

// One float64 problem.
extern "C" int symmetric_downdate_f64(const double* P, const double* M,
                                      const double* keep, double* out, int D,
                                      int m, cudaStream_t stream) {
  return launch_dmma(P, M, keep, out, 1, D, m, 0, 0, 0, stream);
}
