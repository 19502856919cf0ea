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
// * the row-slab entry points (symmetric_downdate_rows_*) compute rows
//   [r0, r0 + R) of the same output, for a landmark-sharded filter whose
//   rank holds only those rows of P. Every element must equal, bit for bit,
//   what the full call writes there, so a slab block computes exactly one
//   of the full kernel's lower-triangle tiles (bi, bj), with the same loads,
//   k-order and MMAs, and its epilogue writes the slab's part of that tile
//   and of its mirror (bj, bi). The slab's row tiles are bi0 .. bi1 (r0
//   need not be tile-aligned): a column tile sj outside them pairs with
//   each row tile si once, and the pairs of two row tiles inside are the
//   nr (nr + 1) / 2 lower-triangle tiles among them, each computed once and
//   written to both output tiles. That is nr (nt - nr) + nr (nr + 1) / 2
//   blocks for nr row tiles and nt column tiles: a slab of every row is the
//   full call's grid. The full kernel reads P's lower half; a slab reads its
//   own rows (P[s][c] for c > s where the full kernel reads P[c][s]), so the
//   two agree bit for bit when P is exactly symmetric, the filter's
//   invariant. In float32 an element's bits do not depend on the tile that
//   computes it (one fmaf chain from 0 in increasing a), so a float32 slab
//   at 128-wide tiles lays its grid from its own first row (lp zero columns
//   lead M's in the padded copy: a slab of 9 x 128 rows is 9 row tiles, not
//   10) and computes a cross tile as it lies, the slab's rows against its
//   columns. Its blocks fill two an SM; where the last wave would hold at
//   most one tile an SM, those tiles run as two blocks of 64 columns each
//   (`split`): a tile alone on an SM took about half a wave's time.
// * thin slabs (the camera rows: R = 13) take a kernel of their own
//   (thin_kernel, thin_kernel_dmma): 128-wide tiles would give one short
//   wave of blocks that each compute a 128 x 128 tile, 1536 deep, to keep
//   13 of its rows (10x the FMAs the rows need). A thin block owns 16 of
//   the slab's rows against CW output columns, so D / CW blocks spread
//   over the card; M's columns stream through a cp.async ring straight from
//   M (no padded copy, so one launch), the slab's own columns of M, which
//   every block reads, from L2. What bounds the card is M's bytes, read
//   once; what bounds this kernel is its 4-byte copies (see Thin).
//   float32: one fmaf chain an output from 0 in increasing a, as the full
//   kernel's. float64: one m16n8k16 DMMA a 16-row panel of M in increasing
//   order, the slab's rows the A operand and the columns B, as the full
//   kernel's panels; an element's bits are then its two columns' products
//   in the tensor core's order, whatever its place in the fragment and
//   whichever of the two is A (the card tests hold it to the full kernel).
//   Inside the slab's own rows an element and its mirror are computed
//   apart, from the same products in the same order.
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

// Mp [m, Dp] = M [m, D] behind lp zero columns, zero columns past them;
// one block per row, blockIdx.y the problem of a batch (M and Mp offset by
// sM and sMp floats).
__global__ void pad_rows(const float* __restrict__ M, float* __restrict__ Mp,
                         int D, int Dp, int lp, long long sM, long long sMp) {
  const size_t k = blockIdx.x;
  M += blockIdx.y * sM;
  Mp += blockIdx.y * sMp;
  for (int c = threadIdx.x; c < Dp; c += blockDim.x)
    Mp[k * Dp + c] = c >= lp && c - lp < D ? M[k * D + c - lp] : 0.f;
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

// A row slab: output rows [r0, r0 + R) of a [D,D] result in its nr row
// tiles bi0 .. bi0 + nr - 1, of nt tiles across D. The tile grid may start
// lp rows and columns before the output (a float32 slab's grid starts at
// its first row); r0, bi0 and nt count in the grid's coordinates, where
// the output's row or column x is x + lp.
// A float32 slab may compute its last `split` cross tiles (see block_tile)
// as two halves of TILE / 2 columns each, two blocks.
struct Rows {
  int r0, R, bi0, nr, nt, lp, split;
};

template <int N>
struct IntC {
  static constexpr int value = N;
};

// the launch modes of the kernels: one problem, a batch, a row slab
enum Mode { SINGLE, BATCHED, ROWS };

// The tile (bi, bj), bi >= bj, that block x computes: the x-th
// lower-triangle tile, or for a slab first the lower-triangle tiles among
// its row tiles (x < nr (nr + 1) / 2; most write two output tiles, so they
// start first), then its row tiles si against the column tiles sj outside
// them (cross tiles); (si, sj) is the output tile whose slab part the block
// writes, and for a pair of two row tiles of the slab its mirror. The last
// rows.split cross tiles take two blocks each, `half` 0 and 1 (else -1).
__device__ __forceinline__ void block_tile(int mode, const Rows& rows,
                                           long long& bi, long long& bj,
                                           int& si, int& sj, int& half) {
  half = -1;
  if (mode == ROWS) {
    const long long x = blockIdx.x;
    const long long inside = (long long)rows.nr * (rows.nr + 1) / 2;
    if (x < inside) {
      long long a, b;
      tile_of_block(x, a, b);
      si = rows.bi0 + (int)a;
      sj = rows.bi0 + (int)b;
    } else {
      const int w = rows.nt - rows.nr;
      const long long whole = (long long)rows.nr * w - rows.split;
      long long u = x - inside;
      if (u >= whole) {
        half = (int)((u - whole) % 2);
        u = whole + (u - whole) / 2;
      }
      si = rows.bi0 + (int)(u / w);
      sj = (int)(u % w);
      if (sj >= rows.bi0) sj += rows.nr;
    }
    bi = si > sj ? si : sj;
    bj = si > sj ? sj : si;
  } else {
    tile_of_block(blockIdx.x, bi, bj);
    si = (int)bi;
    sj = (int)bj;
  }
}

// whether output tile (sj, si), the mirror of a slab block's tile, lies in
// the slab too (and is another tile)
__device__ __forceinline__ bool mirror_in_slab(int si, int sj,
                                               const Rows& rows) {
  return si != sj && sj >= rows.bi0 && sj < rows.bi0 + rows.nr;
}

// The slab epilogue. `tile` holds the accumulators of the tile (i0, j0)
// (the caller synchronised after writing them); output tile (si, sj)'s
// elements (s, c) inside the slab, in its columns TILE sj + c_lo .. + c_n
// - 1, become out[s - r0][c] = k_s k_c (P_rows[s - r0][c] - acc(s, c)), the
// value the full call writes at (s, c) (grid coordinates, less lp for the
// output's). acc(s, c) is the tile's (s - i0, c - j0), or with `flip` its
// (c - i0, s - j0); a diagonal tile's (max - i0, min - j0), the lower half
// the full call reads, whose P read is P[max][min]. Only the tile's rows
// inside the slab are visited, consecutive threads on consecutive c,
// EPI_LOADS loads of P in flight a thread as in write_tile.
template <int TILE, int THREADS, bool HAS_KEEP, typename T>
__device__ __forceinline__ void write_rows(const T* tile,
                                           const T* __restrict__ P_rows,
                                           const T* __restrict__ keep,
                                           T* __restrict__ out, int D, int i0,
                                           int j0, int si, int sj,
                                           const Rows& rows, int tid,
                                           bool flip, int c_lo, int c_n) {
  const int s0 = si * TILE > rows.r0 ? si * TILE : rows.r0;
  const int s1 = si * TILE + TILE < rows.r0 + rows.R ? si * TILE + TILE
                                                     : rows.r0 + rows.R;
  const int n = (s1 - s0) * TILE;
  for (int e0 = tid; e0 < n; e0 += EPI_LOADS * THREADS) {
    T pv[EPI_LOADS], kv[EPI_LOADS];
#pragma unroll
    for (int u = 0; u < EPI_LOADS; ++u) {
      const int e = e0 + u * THREADS;
      const int s = s0 + e / TILE - rows.lp;
      const int c = sj * TILE + e % TILE - rows.lp;
      const bool ok = e < n && c >= 0 && c < D &&
                      (unsigned)(e % TILE - c_lo) < (unsigned)c_n;
      const size_t o = (size_t)(s + rows.lp - rows.r0) * D + c;
      pv[u] = ok ? P_rows[o] : T(0);
      if (HAS_KEEP) kv[u] = ok ? keep[s > c ? s : c] * keep[s > c ? c : s] : T(0);
    }
#pragma unroll
    for (int u = 0; u < EPI_LOADS; ++u) {
      const int e = e0 + u * THREADS;
      const int s = s0 + e / TILE, c = sj * TILE + e % TILE;
      if (e < n && c >= rows.lp && c - rows.lp < D &&
          (unsigned)(e % TILE - c_lo) < (unsigned)c_n) {
        const bool diag = si == sj;
        const int i = diag ? (s > c ? s : c) : flip ? c : s;
        const int j = diag ? (s > c ? c : s) : flip ? s : c;
        T v = pv[u] - tile[(i - i0) * (TILE + 1) + (j - j0)];
        if (HAS_KEEP) v *= kv[u];
        out[(size_t)(s - rows.r0) * D + c - rows.lp] = v;
      }
    }
  }
}

// blockIdx.x: the output tile. MODE BATCHED: blockIdx.y is the problem of
// a batch, whose P, M (rows ld floats apart) and keep start sP, sM and sK
// floats on (0 for one shared by every problem) and whose output starts
// b D^2 floats on; a single problem (SINGLE) takes the kernel without that
// addressing (on an H100 it cost the flagship shape's call 4% of its
// device time). ROWS: a row slab (`rows`), P its rows and out [R,D].
template <int TILE, bool HAS_KEEP, int MODE>
__global__ void __launch_bounds__(Cfg<TILE>::THREADS, Cfg<TILE>::MIN_BLOCKS)
downdate_kernel(const float* __restrict__ P, const float* __restrict__ Ms,
                const float* __restrict__ keep, float* __restrict__ out,
                int D, int ld, int m, long long sP, long long sM,
                long long sK, Rows rows) {
  using C = Cfg<TILE>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  if constexpr (MODE == BATCHED) {
    const long long b = blockIdx.y;
    P += b * sP;
    Ms += b * sM;
    if (HAS_KEEP) keep += b * sK;
    out += b * (long long)D * D;
  }

  long long bi, bj;
  int si, sj, half;
  block_tile(MODE, rows, bi, bj, si, sj, half);
  if constexpr (MODE == ROWS) {
    // a cross tile is computed as it lies, the slab's rows against its
    // columns (a float32 element's bits do not depend on the tile), a split
    // one in two blocks of TILE / 2 columns (the first column group of a
    // thread's register tile)
    if (sj < rows.bi0 || sj >= rows.bi0 + rows.nr) {
      bi = si;
      bj = sj;
    }
  }
  const int i0 = (int)bi * TILE;
  const int j0 = (int)bj * TILE + (half > 0 ? TILE / 2 : 0);

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
  // the k-loop over QH of the H column groups of the register tile
  auto k_loop = [&](auto qh) {
    constexpr int QH = decltype(qh)::value;
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
        for (int h = 0; h < C::H; ++h)
          load4(si + kk * TILE + h * C::HALF + 4 * ty, a + 4 * h);
#pragma unroll
        for (int h = 0; h < QH; ++h)
          load4(sj + kk * TILE + h * C::HALF + 4 * tx, b + 4 * h);
#pragma unroll
        for (int p = 0; p < C::RT; ++p)
#pragma unroll
          for (int q = 0; q < 4 * QH; ++q)
            acc[p][q] = fmaf(a[p], b[q], acc[p][q]);
      }
    }
  };
  if constexpr (MODE == ROWS && C::H == 2) {
    if (half >= 0)
      k_loop(IntC<1>{});
    else
      k_loop(IntC<C::H>{});
  } else {
    k_loop(IntC<C::H>{});
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
  if constexpr (MODE == ROWS) {
    write_rows<TILE, C::THREADS, HAS_KEEP>(
        tile, P, keep, out, D, i0, j0, si, sj, rows, tid, bi != si,
        half > 0 ? TILE / 2 : 0, half >= 0 ? TILE / 2 : TILE);
    if (mirror_in_slab(si, sj, rows))
      write_rows<TILE, C::THREADS, HAS_KEEP>(tile, P, keep, out, D, i0, j0,
                                             sj, si, rows, tid, bi != sj, 0,
                                             TILE);
  } else
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
// the batch axis (MODE BATCHED) and the row slab (ROWS) as in
// downdate_kernel
template <bool HAS_KEEP, int MODE>
__global__ void __launch_bounds__(Cfg64::THREADS, Cfg64::MIN_BLOCKS)
downdate_kernel_dmma(const double* __restrict__ P, const double* __restrict__ M,
                     const double* __restrict__ keep, double* __restrict__ out,
                     int D, int m, long long sP, long long sM, long long sK,
                     Rows rows) {
  using C = Cfg64;
  constexpr int TILE = C::TILE;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* smem = reinterpret_cast<double*>(smem_raw);
  if constexpr (MODE == BATCHED) {
    const long long b = blockIdx.y;
    P += b * sP;
    M += b * sM;
    if (HAS_KEEP) keep += b * sK;
    out += b * (long long)D * D;
  }

  long long bi, bj;
  int si, sj, half;   // float64 slabs are not split: half is -1
  block_tile(MODE, rows, bi, bj, si, sj, half);
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
  if constexpr (MODE == ROWS) {
    write_rows<TILE, C::THREADS, HAS_KEEP>(tile, P, keep, out, D, i0, j0, si,
                                           sj, rows, tid, bi != si, 0, TILE);
    if (mirror_in_slab(si, sj, rows))
      write_rows<TILE, C::THREADS, HAS_KEEP>(tile, P, keep, out, D, i0, j0,
                                             sj, si, rows, tid, bi != sj, 0,
                                             TILE);
  } else
    write_tile<TILE, C::THREADS, HAS_KEEP>(tile, P, keep, out, D, i0, j0,
                                           bi == bj, tid);
}

// ---- thin row slabs ----

// A block: ROWS of the slab's rows (blockIdx.y picks which) against CW
// output columns (blockIdx.x), a warp 16 rows x 16 columns (float32: a
// thread 4 rows x 2 columns; float64: two DMMA tiles), and every thread
// copies too. A stage is KP rows of M: the slab's strip [KP][LA] (its rows'
// columns of M) and the block's columns' [KP][LB], copied an element at a
// time, coalesced across the warp (rows of M start at k D elements, D odd).
// On an H100 the float32 kernel's time is set by these copies and by how
// many blocks an SM holds: at the camera rows one block an SM (CW = 48 at
// D = 4621) with few deep stages ran fastest; 16-byte copies into a
// shifted layout, a copy warp beside the compute warps, copies staged
// through registers, TMA boxes of M seen as aligned lines of 4 rows, and
// other thread tiles were all slower (PERF.md).
// float32 rows are 16-byte aligned for the float4 loads, float64 rows 4
// doubles longer than they hold, so that a half-warp's fragment loads hit
// 16 distinct bank pairs, as in Cfg64.
template <int CW, typename T>
struct Thin {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int ROWS = 16;
  static constexpr int THREADS = 2 * CW;
  static constexpr int KP = F32 ? 48 : 32;
  static constexpr int STAGES = F32 ? 3 : 4;
  static constexpr int PAD = F32 ? 0 : 4;
  static constexpr int LA = ROWS + PAD, LB = CW + PAD;
  static constexpr int STAGE = KP * (LA + LB);
  static constexpr int SMEM = STAGES * STAGE * (int)sizeof(T);
  static_assert(CW % 16 == 0 && STAGE % 4 == 0 && THREADS % 32 == 0,
                "layout");
};

// Copies of stage `st` of M's rows into the ring: the slab's columns r0 ..
// r0 + rows - 1 and the block's c0 .. c0 + CW - 1, zero past them, past D
// and past m
template <int CW, typename T>
__device__ __forceinline__ void thin_stage(T* smem, const T* __restrict__ M,
                                           int D, int m, int st, int r0,
                                           int rows, int c0, int tid) {
  using C = Thin<CW, T>;
  static_assert(C::KP * C::ROWS % C::THREADS == 0 &&
                    C::KP * CW % C::THREADS == 0, "copies a thread");
  T* sa = smem + (st % C::STAGES) * C::STAGE;
  T* sb = sa + C::KP * C::LA;
#pragma unroll
  for (int u = 0; u < C::KP * C::ROWS / C::THREADS; ++u) {
    const int e = tid + u * C::THREADS;
    const int k = st * C::KP + e / C::ROWS, r = e % C::ROWS;
    const bool ok = k < m && r < rows;
    cp_async<sizeof(T)>(sa + (e / C::ROWS) * C::LA + r,
                        M + (ok ? (size_t)k * D + r0 + r : 0), ok);
  }
#pragma unroll
  for (int u = 0; u < C::KP * CW / C::THREADS; ++u) {
    const int e = tid + u * C::THREADS;
    const int k = st * C::KP + e / CW, c = e % CW;
    const bool ok = k < m && c0 + c < D;
    cp_async<sizeof(T)>(sb + (e / CW) * C::LB + c,
                        M + (ok ? (size_t)k * D + c0 + c : 0), ok);
  }
}

// out[s][c] = k_{r0+s} k_c (P_rows[s][c] - acc) for slab row s (counted
// from r0) and column c: the full call's value there
template <bool HAS_KEEP, typename T>
__device__ __forceinline__ void thin_write(T acc, const T* __restrict__ P_rows,
                                           const T* __restrict__ keep,
                                           T* __restrict__ out, int D, int r0,
                                           int s, int c) {
  const size_t o = (size_t)s * D + c;
  T v = P_rows[o] - acc;
  if (HAS_KEEP) v *= keep[r0 + s] * keep[c];
  out[o] = v;
}

// float32: a thread 4 rows x 2 columns of its warp's patch (rows 4 (lane
// / 8) .., columns 2 (8 warp + lane % 8) ..), 8 fmaf chains
template <int CW, bool HAS_KEEP>
__global__ void __launch_bounds__(Thin<CW, float>::THREADS)
thin_kernel(const float* __restrict__ P_rows, const float* __restrict__ M,
            const float* __restrict__ keep, float* __restrict__ out, int D,
            int m, int r0, int R) {
  using C = Thin<CW, float>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c0 = blockIdx.x * CW, y0 = blockIdx.y * C::ROWS;
  const int rows = min(C::ROWS, R - y0);
  const int ra = 4 * (lane / 8), cb = 2 * (8 * warp + lane % 8);
  const int n_st = (m + C::KP - 1) / C::KP;

  float acc[4][2];
#pragma unroll
  for (int p = 0; p < 4; ++p)
    acc[p][0] = acc[p][1] = 0.f;
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < n_st) thin_stage<CW>(smem, M, D, m, s, r0 + y0, rows, c0, tid);
    cp_async_commit();
  }
  for (int st = 0; st < n_st; ++st) {
    // stage st has landed for every thread, and every thread is done with
    // the stage the next copies overwrite (st - 1's)
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();
    if (st + C::STAGES - 1 < n_st)
      thin_stage<CW>(smem, M, D, m, st + C::STAGES - 1, r0 + y0, rows, c0, tid);
    cp_async_commit();
    const float* sa = smem + (st % C::STAGES) * C::STAGE + ra;
    const float* sb = smem + (st % C::STAGES) * C::STAGE + C::KP * C::LA + cb;
#pragma unroll
    for (int kk = 0; kk < C::KP; ++kk) {
      float a[4];
      load4(sa + kk * C::LA, a);
      const float2 b = *reinterpret_cast<const float2*>(sb + kk * C::LB);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        acc[p][0] = fmaf(a[p], b.x, acc[p][0]);
        acc[p][1] = fmaf(a[p], b.y, acc[p][1]);
      }
    }
  }
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 2; ++q)
      if (ra + p < rows && c0 + cb + q < D)
        thin_write<HAS_KEEP>(acc[p][q], P_rows, keep, out, D, r0,
                             y0 + ra + p, c0 + cb + q);
}

// float64: a warp's 16 x 16 patch is two m16n8k16 DMMAs a 16-row panel (A
// the slab's rows, B the columns), fragments as in downdate_kernel_dmma
template <int CW, bool HAS_KEEP>
__global__ void __launch_bounds__(Thin<CW, double>::THREADS)
thin_kernel_dmma(const double* __restrict__ P_rows,
                 const double* __restrict__ M, const double* __restrict__ keep,
                 double* __restrict__ out, int D, int m, int r0, int R) {
  using C = Thin<CW, double>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* smem = reinterpret_cast<double*>(smem_raw);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int c0 = blockIdx.x * CW, y0 = blockIdx.y * C::ROWS;
  const int rows = min(C::ROWS, R - y0);
  const int n_st = (m + C::KP - 1) / C::KP;

  double acc[2][4];
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[q][v] = 0.0;
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < n_st) thin_stage<CW>(smem, M, D, m, s, r0 + y0, rows, c0, tid);
    cp_async_commit();
  }
  for (int st = 0; st < n_st; ++st) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();
    if (st + C::STAGES - 1 < n_st)
      thin_stage<CW>(smem, M, D, m, st + C::STAGES - 1, r0 + y0, rows, c0, tid);
    cp_async_commit();
    const double* sa = smem + (st % C::STAGES) * C::STAGE + g;
    const double* sb = sa + C::KP * C::LA + warp * 16;
#pragma unroll
    for (int k16 = 0; k16 < C::KP; k16 += 16) {
      // the full kernel runs no panel wholly past m
      if (st * C::KP + k16 >= m) break;
      double a[8], b[2][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = sa[(k16 + t + 4 * (i / 2)) * C::LA + 8 * (i % 2)];
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i) b[q][i] = sb[(k16 + t + 4 * i) * C::LB + 8 * q];
#pragma unroll
      for (int q = 0; q < 2; ++q) dmma(acc[q], a, b[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int r = g + 8 * (v / 2), c = c0 + warp * 16 + 8 * q + 2 * t + v % 2;
      if (r < rows && c < D)
        thin_write<HAS_KEEP>(acc[q][v], P_rows, keep, out, D, r0, y0 + r, c);
    }
}

// The shared-memory attributes of `kernel`, set once per device: `ready`
// holds one bit per device, one variable per kernel. With `max_shared` the
// SM's L1 / shared split is asked to favour shared memory (else the driver
// picks it: the thin kernels, which need little, ran faster so in float64).
template <typename Kernel>
cudaError_t set_smem(Kernel kernel, int smem, unsigned long long& ready,
                     bool max_shared = true) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && (ready >> dev & 1ull)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess && max_shared)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < 64) ready |= 1ull << dev;
  return err;
}


template <int TILE, bool HAS_KEEP, int MODE>
cudaError_t prepare() {
  static unsigned long long ready = 0;
  return set_smem(downdate_kernel<TILE, HAS_KEEP, MODE>, Cfg<TILE>::SMEM,
                  ready);
}

template <bool HAS_KEEP, int MODE>
cudaError_t prepare_dmma() {
  static unsigned long long ready = 0;
  return set_smem(downdate_kernel_dmma<HAS_KEEP, MODE>, Cfg64::SMEM, ready);
}

// the kernel of a launch in mode MODE: with or without the keep mask
template <int TILE, int MODE>
decltype(&downdate_kernel<TILE, false, MODE>) pick(bool has_keep,
                                                   cudaError_t& err) {
  if (has_keep) {
    err = prepare<TILE, true, MODE>();
    return downdate_kernel<TILE, true, MODE>;
  }
  err = prepare<TILE, false, MODE>();
  return downdate_kernel<TILE, false, MODE>;
}

template <int MODE>
decltype(&downdate_kernel_dmma<false, MODE>) pick_dmma(bool has_keep,
                                                       cudaError_t& err) {
  if (has_keep) {
    err = prepare_dmma<true, MODE>();
    return downdate_kernel_dmma<true, MODE>;
  }
  err = prepare_dmma<false, MODE>();
  return downdate_kernel_dmma<false, MODE>;
}

// B problems (1 <= B <= 65535, the grid's y extent); a problem's P, M and
// keep start sP, sM and sK values after the previous one's (0: shared)
bool bad_batch(int B, long long sP, long long sM, long long sK) {
  return B < 1 || B > 65535 || sP < 0 || sM < 0 || sK < 0;
}

// whether rows [r0, r0 + R) lie inside a [D,D] output
bool bad_slab(int D, int r0, int R) {
  return D < 1 || R < 1 || r0 < 0 || r0 > D - R;
}

// the slab of rows [r0, r0 + R) of a [D,D] output in TILE-wide tiles whose
// grid starts lp rows and columns before the output, its last `split`
// cross tiles in halves, and its blocks, or false when it does not lie
// inside [0, D) or has fewer cross tiles
bool slab_of(int D, int r0, int R, int tile, int lp, int split, Rows& rows,
             unsigned int& blocks) {
  if (bad_slab(D, r0, R) || split < 0) return false;
  rows.lp = lp;
  rows.split = split;
  rows.r0 = r0 + lp;
  rows.R = R;
  rows.bi0 = rows.r0 / tile;
  rows.nr = (rows.r0 + R - 1) / tile - rows.bi0 + 1;
  rows.nt = (D + lp + tile - 1) / tile;
  if (split > rows.nr * (rows.nt - rows.nr)) return false;
  blocks = (unsigned int)(rows.nr * (rows.nt - rows.nr) +
                          rows.nr * (rows.nr + 1) / 2 + split);
  return true;
}

// B problems (MODE SINGLE or BATCHED: one lower-triangle tile a block) or
// a row slab of one (MODE ROWS, `rows` and its `blocks`)
template <int TILE, int MODE>
int launch(const float* P, const float* M, const float* keep, float* Mp,
           float* out, int B, int D, int m, long long sP, long long sM,
           long long sK, const Rows& rows, unsigned int blocks,
           cudaStream_t stream) {
  using C = Cfg<TILE>;
  if (C::PADDED && Mp == nullptr) return (int)cudaErrorInvalidValue;
  if (bad_batch(B, sP, sM, sK)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  auto kernel = pick<TILE, MODE>(keep != nullptr, err);
  if (err != cudaSuccess) return (int)err;
  int ld = D;
  if (C::PADDED) {
    // a shared M is padded once; a slab's grid origin lp leads the rows
    ld = (D + rows.lp + 3) / 4 * 4;
    const long long sMp = sM == 0 ? 0 : (long long)m * ld;
    pad_rows<<<dim3(m, sM == 0 ? 1 : B), 256, 0, stream>>>(
        M, Mp, D, ld, rows.lp, sM, sMp);
    M = Mp;
    sM = sMp;
  }
  if (MODE != ROWS) {
    const unsigned int nt = (D + TILE - 1) / TILE;
    blocks = nt * (nt + 1) / 2;
  }
  kernel<<<dim3(blocks, B), C::THREADS, C::SMEM, stream>>>(
      P, M, keep, out, D, ld, m, sP, sM, sK, rows);
  return (int)cudaGetLastError();
}

// the full call of B problems in TILE-wide tiles
template <int TILE>
int launch_full(const float* P, const float* M, const float* keep, float* Mp,
                float* out, int B, int D, int m, long long sP, long long sM,
                long long sK, cudaStream_t stream) {
  return B > 1 ? launch<TILE, BATCHED>(P, M, keep, Mp, out, B, D, m, sP, sM,
                                       sK, Rows{}, 0, stream)
               : launch<TILE, SINGLE>(P, M, keep, Mp, out, B, D, m, sP, sM,
                                      sK, Rows{}, 0, stream);
}

int launch_dmma(const double* P, const double* M, const double* keep,
                double* out, int B, int D, int m, long long sP, long long sM,
                long long sK, const Rows* slab, unsigned int slab_blocks,
                cudaStream_t stream) {
  using C = Cfg64;
  if (bad_batch(B, sP, sM, sK)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSuccess;
  auto kernel = slab ? pick_dmma<ROWS>(keep != nullptr, err)
                : B > 1 ? pick_dmma<BATCHED>(keep != nullptr, err)
                        : pick_dmma<SINGLE>(keep != nullptr, err);
  if (err != cudaSuccess) return (int)err;
  const unsigned int nt = (D + C::TILE - 1) / C::TILE;
  const unsigned int blocks = slab ? slab_blocks : nt * (nt + 1) / 2;
  kernel<<<dim3(blocks, B), C::THREADS, C::SMEM, stream>>>(
      P, M, keep, out, D, m, sP, sM, sK, slab ? *slab : Rows{});
  return (int)cudaGetLastError();
}

// the thin kernel of type T (thin_kernel, thin_kernel_dmma) at column
// width CW, with or without the keep mask
template <int CW, bool HAS_KEEP, typename T>
cudaError_t thin_prepared(void (*&kernel)(const T*, const T*, const T*, T*,
                                          int, int, int, int)) {
  static unsigned long long ready = 0;
  if constexpr (sizeof(T) == 4)
    kernel = thin_kernel<CW, HAS_KEEP>;
  else
    kernel = thin_kernel_dmma<CW, HAS_KEEP>;
  return set_smem(kernel, Thin<CW, T>::SMEM, ready, false);
}

// a thin slab: ceil(D / CW) x ceil(R / 16) blocks, one launch
template <int CW, typename T>
int launch_thin(const T* P_rows, const T* M, const T* keep, T* out, int D,
                int m, int r0, int R, cudaStream_t stream) {
  using C = Thin<CW, T>;
  void (*kernel)(const T*, const T*, const T*, T*, int, int, int, int) =
      nullptr;
  const cudaError_t err = keep ? thin_prepared<CW, true>(kernel)
                               : thin_prepared<CW, false>(kernel);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((D + CW - 1) / CW, (R + C::ROWS - 1) / C::ROWS);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(P_rows, M, keep, out, D, m, r0,
                                                R);
  return (int)cudaGetLastError();
}

template <typename T>
int thin_slab(const T* P_rows, const T* M, const T* keep, T* out, int D, int m,
              int r0, int R, int cw, cudaStream_t stream) {
  if (bad_slab(D, r0, R) || m < 1 || (R + 15) / 16 > 65535)
    return (int)cudaErrorInvalidValue;
  switch (cw) {
    case 16: return launch_thin<16>(P_rows, M, keep, out, D, m, r0, R, stream);
    case 32: return launch_thin<32>(P_rows, M, keep, out, D, m, r0, R, stream);
    case 48:
      // float32 only (a float64 block of 96 threads would not divide its
      // copies)
      if constexpr (sizeof(T) == 4)
        return launch_thin<48>(P_rows, M, keep, out, D, m, r0, R, stream);
      return (int)cudaErrorInvalidValue;
    case 64: return launch_thin<64>(P_rows, M, keep, out, D, m, r0, R, stream);
    default: return (int)cudaErrorInvalidValue;
  }
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
      return launch_full<32>(P, M, keep, Mp, out, B, D, m, sP, sM, sK, stream);
    case 128:
      return launch_full<128>(P, M, keep, Mp, out, B, D, m, sP, sM, sK,
                              stream);
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
  return launch_dmma(P, M, keep, out, B, D, m, sP, sM, sK, nullptr, 0,
                     stream);
}

// One float64 problem.
extern "C" int symmetric_downdate_f64(const double* P, const double* M,
                                      const double* keep, double* out, int D,
                                      int m, cudaStream_t stream) {
  return launch_dmma(P, M, keep, out, 1, D, m, 0, 0, 0, nullptr, 0, stream);
}

// Rows [r0, r0 + R) of symmetric_downdate_f32's output for P, M and keep,
// each element bit for bit the full call's when P is exactly symmetric:
// P_rows [R,D] (rows r0 .. r0 + R - 1 of P, all read), M [m,D], keep [D] or
// NULL, out [R,D]; TILE 32 or 128 (whatever the full call's). At TILE =
// 128 the tile grid starts at row r0 (lp = (128 - r0 % 128) % 128 columns
// of zeros lead M's in the scratch; Mp is m x Dp floats, Dp = D + lp
// rounded up to 4) and the last `split` of its cross tiles are computed in
// halves (0 at the other edges). 0 <= r0 <= D - R.
extern "C" int symmetric_downdate_rows_f32(const float* P_rows, const float* M,
                                           const float* keep, float* Mp,
                                           float* out, int D, int m, int r0,
                                           int R, int tile, int split,
                                           cudaStream_t stream) {
  Rows rows;
  unsigned int blocks = 0;
  if ((tile != 32 && tile != 128) || (split && tile != 128) ||
      !slab_of(D, r0, R, tile, tile == 128 ? (128 - r0 % 128) % 128 : 0,
               split, rows, blocks))
    return (int)cudaErrorInvalidValue;
  switch (tile) {
    case 32:
      return launch<32, ROWS>(P_rows, M, keep, Mp, out, 1, D, m, 0, 0, 0, rows,
                              blocks, stream);
    default:
      return launch<128, ROWS>(P_rows, M, keep, Mp, out, 1, D, m, 0, 0, 0,
                               rows, blocks, stream);
  }
}

// The same for float64 (the DMMA kernel's 64-wide tiles).
extern "C" int symmetric_downdate_rows_f64(const double* P_rows,
                                           const double* M, const double* keep,
                                           double* out, int D, int m, int r0,
                                           int R, cudaStream_t stream) {
  Rows rows;
  unsigned int blocks = 0;
  if (!slab_of(D, r0, R, Cfg64::TILE, 0, 0, rows, blocks))
    return (int)cudaErrorInvalidValue;
  return launch_dmma(P_rows, M, keep, out, 1, D, m, 0, 0, 0, &rows, blocks,
                     stream);
}

// The same rows by the thin kernels (no scratch, one launch): a block 16
// rows x cw columns (cw 16, 32, 48 or 64 in float32; 16, 32 or 64 in
// float64, DMMA).
extern "C" int symmetric_downdate_rows_thin_f32(const float* P_rows,
                                                const float* M,
                                                const float* keep, float* out,
                                                int D, int m, int r0, int R,
                                                int cw, cudaStream_t stream) {
  return thin_slab(P_rows, M, keep, out, D, m, r0, R, cw, stream);
}

extern "C" int symmetric_downdate_rows_thin_f64(const double* P_rows,
                                                const double* M,
                                                const double* keep,
                                                double* out, int D, int m,
                                                int r0, int R, int cw,
                                                cudaStream_t stream) {
  return thin_slab(P_rows, M, keep, out, D, m, r0, R, cw, stream);
}
