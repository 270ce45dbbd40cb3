// Packed-columns AND-OR product on Hopper (sm_90a), with a plain C
// interface for ctypes (no PyTorch headers: this file builds in seconds).
//
//   C[m, w] (|)= OR_{l : A[m, l] != 0} B[l, w]
//
//   A  [M, L] int8   — per-step operand (closure mask AND bit table)
//   B  [L, W] int32  — packed state rows, 32 x-columns per word
//   C  [M, W] int32  — packed output rows
//
// All three are row-major and contiguous.  Words carry the uint32 bit
// pattern in int32 storage, so the sign bit is just bit 31.  With
// `accumulate` set the kernels OR their product into C instead of
// overwriting it (C must not alias A or B).
//
// Five entry points, two of them also with a row count read from card
// memory (the `_n` forms below), and batched forms of those:
//
//   packed_cols_list    one pass over A: per 64-row block, the ascending
//                       list of contraction indices l that some row of
//                       the block selects, each with its 64-bit row mask
//   packed_andor_list   the same lists, packed densely, for an A packed
//                       along the contraction: with packed_cols_sparse
//                       it is the packed-contraction product
//   packed_cols_sparse  walks those lists: work ∝ nnz(A)·W
//   packed_cols_dense   int8 tensor cores (mma.sync m16n8k32 s8) on B
//                       unpacked to bit planes in shared memory
//   packed_cols_dense_batched
//                       the same kernel over a batch of independent
//                       products, one grid axis over the copies
//
// The batched row-count forms, packed_cols_dense_n_batched,
// packed_cols_list_n_batched and packed_cols_sparse_batched, run one
// product per copy of a batch in one launch, each copy with its own
// operands, its own list region and (the _n forms) its own row count
// n_rows[copy] on the card: the cohort plane's step (a lane a tenant)
// contracts one window slot for every lane at once, and a lane whose
// window is clean gets 0 rows.  Copy offsets are 64-bit (one lane's
// state is past 2^31 words at 64k classes).
//
// packed_cols_list_n and packed_cols_dense_n are packed_cols_list and
// packed_cols_dense with a row count n read from card memory when the
// kernel starts: only rows m < n are computed and written (n <= 0 makes
// the launch a no-op).  The fused K-round window of the row-packed
// engine launches them from a CUDA graph, where no host decision can
// skip a launch: a contraction window whose inputs are clean gets n = 0
// (the launch returns at once), and a sparse round's operand, sized for
// the workspace's capacity, gets n = the rows the round selected.  The
// dense form always ORs into C.
//
// Nothing here counts in a type that can wrap: the sparse kernel only
// ORs whole words, and the dense kernel's int32 counts are at most L.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;          // rows of C per row block (all kernels)
constexpr int LCHUNK = 256;     // contraction columns per list chunk

// ------------------------------------------------------------ async copy

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared, bypassing L1; src_bytes < 16 zero-fills the rest
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// packed_cols_list
//
// The counterpart of the reference's inline flags/plk pass
// (distel_tpu/ops/bitmatmul.py, PackedColsMatmulPlan.__call__ with
// skip_zero_tiles=True), at a contraction tile of one column and with
// the row mask kept beside each listed column.
//
// Output, for row block g (rows 64g .. 64g+63) and list chunk c
// (columns LCHUNK·c .. LCHUNK·(c+1)-1), at entry e = (g·NCH + c)·LCHUNK:
//   cols[e + j]   ascending contraction indices l with some A[m, l] != 0
//   masks[e + j]  bit r set iff A[64g + r, l] != 0
//   counts[g·NCH + c] = number of entries (j < counts are valid)
//
// Bound: it reads A once (M·L bytes) and writes at most 12 bytes per
// listed column.  Design: one block per (chunk, row block) so the card
// fills even when M is small; each warp reads 32 rows × 32 contiguous
// bytes (two 16-byte loads a lane, whole 32-byte sectors) and turns
// them into 32 column masks of 32 rows with __ballot_sync; two warps
// make the 64-row mask.  Live columns are compacted in order by a warp
// ballot, __popc prefix and a block prefix over the warps.  No sort and
// no padded copy of A.
// ---------------------------------------------------------------------------
constexpr int LIST_THREADS = 256;
constexpr int LSEG = 128;       // columns per pass: 4 column groups x 2 row halves

template <bool A16>
__global__ void __launch_bounds__(LIST_THREADS) packed_cols_list_kernel(
    const int8_t* __restrict__ A, int32_t* __restrict__ cols,
    uint64_t* __restrict__ masks, int32_t* __restrict__ counts, int M, int L,
    int NCH, const int* __restrict__ n_rows, long long sa) {
  __shared__ uint32_t half_mask[2][LSEG];
  __shared__ int warp_live[LSEG / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int half = warp & 1, cg = warp >> 1;
  const int g = blockIdx.y, c = blockIdx.x;
  // copy blockIdx.z of a batch (0 unbatched): its A, its list region
  // and its row count
  {
    const long long copy = blockIdx.z;
    const long long chunks = (long long)gridDim.y * NCH;
    A += copy * sa;
    cols += copy * chunks * LCHUNK;
    masks += copy * chunks * LCHUNK;
    counts += copy * chunks;
    if (n_rows != nullptr) n_rows += copy;
  }
  // rows past the card-held count list nothing (a whole block past it
  // writes an empty list and stops)
  if (n_rows != nullptr) M = min(M, max(__ldg(n_rows), 0));
  if (g * TM >= M) {
    if (tid == 0) counts[(size_t)g * NCH + c] = 0;
    return;
  }
  const int m = g * TM + half * 32 + lane;
  const bool row_ok = m < M;
  const int8_t* arow = A + (size_t)(row_ok ? m : 0) * L;
  const size_t out0 = ((size_t)g * NCH + c) * LCHUNK;
  const int c_end = min(L, (c + 1) * LCHUNK);
  int base = 0;
  for (int s0 = c * LCHUNK; s0 < c_end; s0 += LSEG) {
    const int col0 = s0 + cg * 32;
    uint32_t w[8];
    if (A16) {
      // L % 16 == 0: a 16-byte piece lies wholly inside or past the row
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int cc = col0 + 16 * h;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (row_ok && cc < L) v = __ldg(reinterpret_cast<const uint4*>(arow + cc));
        w[4 * h] = v.x; w[4 * h + 1] = v.y; w[4 * h + 2] = v.z; w[4 * h + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        uint32_t x = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int cc = col0 + 4 * i + b;
          const uint32_t v = (row_ok && cc < L) ? (uint8_t)arow[cc] : 0u;
          x |= v << (8 * b);
        }
        w[i] = x;
      }
    }
    uint32_t mine = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const uint32_t b = __ballot_sync(0xffffffffu, (w[j >> 2] >> (8 * (j & 3))) & 0xffu);
      if (lane == j) mine = b;
    }
    half_mask[half][cg * 32 + lane] = mine;
    __syncthreads();
    uint64_t mk = 0;
    if (tid < LSEG) mk = (uint64_t)half_mask[0][tid] | ((uint64_t)half_mask[1][tid] << 32);
    const bool live = mk != 0;           // columns past L were read as zero
    const uint32_t bal = __ballot_sync(0xffffffffu, live);
    if (lane == 0 && warp < LSEG / 32) warp_live[warp] = __popc(bal);
    __syncthreads();
    if (live) {
      int pos = base + __popc(bal & ((1u << lane) - 1u));
      for (int v = 0; v < warp; ++v) pos += warp_live[v];
      cols[out0 + pos] = s0 + tid;
      masks[out0 + pos] = mk;
    }
#pragma unroll
    for (int v = 0; v < LSEG / 32; ++v) base += warp_live[v];
    __syncthreads();                     // before half_mask/warp_live are rewritten
  }
  if (tid == 0) counts[(size_t)g * NCH + c] = base;
}

// ---------------------------------------------------------------------------
// packed_andor_list
//
// With packed_cols_sparse, replaces distel_tpu/ops/bitmatmul.py::
// _andor_kernel (reached through PackedMatmulPlan.__call__): the packed
// engine's CR4 and CR6,
//
//   C[m, n] = OR_{k < K : bit k of A[m] set} B[k, n]
//
// with A [M, KW] int32 packed along the contraction (bit p of word w is
// k = 32w + p), B [K, N] and C [M, N] 0/1 bytes.  Because B's bytes are
// 0 or 1, ORing them four to a 32-bit word is the byte OR (no carry
// crosses a byte), so the product is packed_cols_sparse run on B and C
// viewed as int32 words [K, N/4] and [M, N/4], over the lists this
// kernel makes of A.  Each listed (row block, k) then reads B's row k
// once per column tile, whatever number of the block's rows set bit k.
//
// Output: lists in packed_cols_list's format, with the contraction
// index k in place of the column l: per row block, the ascending k < K
// that some row of the block sets, each with its 64-bit row mask.  Bits
// at k >= K select nothing and are dropped.  Unlike packed_cols_list's,
// these lists are packed densely: chunk c of a row block holds its
// entries LCHUNK·c .. LCHUNK·(c+1)-1, so every chunk before the last
// nonempty one is full.  packed_cols_sparse streams a block's list in
// batches of at most SP_SE entries that never cross a chunk, and walks
// the counts of the chunks up to its last entry; at the packed engine's
// state (about one live k per 256 for a 64-row block) lists by k range
// would give it batches of about one entry, each a whole trip through
// its copy ring, and a count to walk per chunk.
//
// Bound: it reads A once (4·M·KW bytes) and writes 12 bytes per listed
// entry.  Design: one block per row block, so the running offset of a
// row block's entries never leaves the block; it lists AL_GROUPS chunks
// at a time, one thread per (row, chunk), and loads the next pass's
// words while it lists this one.  Each thread reads its row's 8 chunk
// words, one 32-byte sector (by word: the packed engine's KW is rarely
// a multiple of 4, so wider loads would rarely be aligned).  A pass
// whose words are all zero costs one __syncthreads_or.  Otherwise, per
// word, a warp OR names the bits that some of the warp's 32 rows set,
// and one __ballot_sync per such bit gives its 32-row mask, so the work
// follows A's set bits, not the chunks' positions.  The two warps'
// halves meet in shared memory; each thread then compacts AL_PER
// consecutive positions, placed by a prefix over the block's threads,
// so the entries come out ascending.
// ---------------------------------------------------------------------------
constexpr int AL_THREADS = 1024;
constexpr int AL_GROUPS = AL_THREADS / TM;          // chunks listed a pass
constexpr int AL_WORDS = LCHUNK / 32;               // A words per chunk
constexpr int AL_PER = AL_GROUPS * LCHUNK / AL_THREADS;  // positions a thread compacts

// A row's words of chunk c, with the bits at k >= K cleared (zero for a
// row or chunk past the ends).
__device__ __forceinline__ void andor_chunk_words(
    const uint32_t* __restrict__ arow, bool row_ok, int c, int NCH, int KW, int K,
    uint32_t (&w)[AL_WORDS]) {
#pragma unroll
  for (int i = 0; i < AL_WORDS; ++i) {
    const int wi = c * AL_WORDS + i;
    const int below = K - 32 * wi;                  // bits of word wi at k < K
    uint32_t x = (row_ok && c < NCH && wi < KW && below > 0) ? __ldg(arow + wi) : 0u;
    if (below < 32) x &= (1u << max(below, 0)) - 1u;
    w[i] = x;
  }
}

__global__ void __launch_bounds__(AL_THREADS) packed_andor_list_kernel(
    const uint32_t* __restrict__ A, int32_t* __restrict__ cols,
    uint64_t* __restrict__ masks, int32_t* __restrict__ counts, int M, int KW,
    int K, int NCH) {
  __shared__ uint32_t half_mask[AL_GROUPS][2][LCHUNK];
  __shared__ int warp_live[AL_THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = tid / TM, half = warp & 1;
  const int g = blockIdx.x;
  const int m = g * TM + tid % TM;
  const bool row_ok = m < M;
  const uint32_t* arow = A + (size_t)(row_ok ? m : 0) * KW;
  const size_t out0 = (size_t)g * NCH * LCHUNK;
  uint32_t next[AL_WORDS];
  andor_chunk_words(arow, row_ok, grp, NCH, KW, K, next);
  int base = 0;
  for (int cb = 0; cb < NCH; cb += AL_GROUPS) {
    uint32_t w[AL_WORDS];
    uint32_t any = 0u;
#pragma unroll
    for (int i = 0; i < AL_WORDS; ++i) {
      w[i] = next[i];
      any |= w[i];
    }
    andor_chunk_words(arow, row_ok, cb + AL_GROUPS + grp, NCH, KW, K, next);
    if (!__syncthreads_or(any != 0u)) continue;    // uniform: nothing to list
    for (int i = tid; i < AL_GROUPS * 2 * LCHUNK; i += AL_THREADS)
      (&half_mask[0][0][0])[i] = 0u;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < AL_WORDS; ++i) {
      uint32_t set = __reduce_or_sync(0xffffffffu, w[i]);
      while (set) {                                // uniform across the warp
        const int p = __ffs(set) - 1;
        set &= set - 1u;
        const uint32_t b = __ballot_sync(0xffffffffu, (w[i] >> p) & 1u);
        if (lane == 0) half_mask[grp][half][32 * i + p] = b;
      }
    }
    __syncthreads();
    // positions AL_PER·tid ..: chunk-major, so ascending k across the block
    uint64_t mk[AL_PER];
    int live = 0;
#pragma unroll
    for (int j = 0; j < AL_PER; ++j) {
      const int q = AL_PER * tid + j;
      mk[j] = (uint64_t)half_mask[q / LCHUNK][0][q % LCHUNK] |
              ((uint64_t)half_mask[q / LCHUNK][1][q % LCHUNK] << 32);
      live += mk[j] != 0ull;
    }
    int incl = live;                               // inclusive prefix over the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) warp_live[warp] = incl;
    __syncthreads();
    int pos = base + incl - live;
#pragma unroll
    for (int v = 0; v < AL_THREADS / 32; ++v) {
      if (v < warp) pos += warp_live[v];
      base += warp_live[v];
    }
#pragma unroll
    for (int j = 0; j < AL_PER; ++j) {
      if (mk[j]) {
        cols[out0 + pos] = cb * LCHUNK + AL_PER * tid + j;
        masks[out0 + pos] = mk[j];
        ++pos;
      }
    }
    __syncthreads();                               // before half_mask/warp_live are rewritten
  }
  for (int c = tid; c < NCH; c += AL_THREADS)
    counts[(size_t)g * NCH + c] = max(0, min(LCHUNK, base - LCHUNK * c));
}

// ---------------------------------------------------------------------------
// packed_cols_sparse
//
// Replaces distel_tpu/ops/bitmatmul.py::_packed_cols_sparse_kernel
// (PackedColsMatmulPlan with skip_zero_tiles=True: the plans the auto
// rule sends here, window CR6 and the taxonomy's product at full width).
//
// Bound on this card: the work the data needs is one W-word OR per
// nonzero of A; the bytes are A once, the B rows some nonzero selects
// once, and C once.  At the main path's operands (0.04-0.2 % nonzero)
// the bytes bound it.
//
// Design: the work follows A's nonzeros, not its tiles.  A block owns
// 64 rows x 128 words of C, kept in shared memory, and walks its row
// block's lists (packed_cols_list): for each listed column l, the
// segment B[l, w0 : w0+128] streams through a 3-stage cp.async ring
// (8 segments and their row masks a stage, 16 bytes a thread where W
// allows), so later segments are in flight while the current one is
// ORed into the rows its mask selects (__ffsll over the set bits; each
// thread owns one word column of the tile, so no two threads touch one
// word).  Cost ∝ nnz(A)·W plus the lists, against (live 64x32 tiles)
// x 64 x 32 x W for a kernel that skips only all-zero tiles.  The epilogue writes
// the tile once; with `accumulate` it ORs only nonzero words into C,
// and a row block with an empty list returns at once.
//
// Row blocks' lists differ a lot in length (at the 64k CR4 and CR6
// operands a few are several times the mean), and one block walks its
// list serially, so the longest list would hold the launch.  When the grid
// is small for the card, each row block's list is split evenly over up
// to 16 blocks (grid z); each ORs its share into C with atomicOr (C is
// zeroed first unless accumulating).  OR is order-free, so the words
// do not depend on the split or on the order of the atomics.
// ---------------------------------------------------------------------------
constexpr int SP_TW = 128;      // words of C per block
constexpr int SP_THREADS = SP_TW;
constexpr int SP_SE = 8;        // list entries per stage
constexpr int SP_NST = 3;       // stages in the ring
// A row block's list is split over up to SP_MAX_SPLITS blocks when the
// (column tile, row block) grid alone gives fewer than SP_TARGET_PER_SM
// blocks an SM: one long list then no longer holds the whole launch.
constexpr int SP_TARGET_PER_SM = 16;
constexpr int SP_MAX_SPLITS = 16;

// The cursor (chunk c, entry j) of a row block's e-th list entry.
__device__ __forceinline__ void seek(const int32_t* __restrict__ cnt, int nch,
                                     int e, int& c, int& j) {
  for (c = 0; c < nch; ++c) {
    const int n = __ldg(cnt + c);
    if (e < n) break;
    e -= n;
  }
  j = e;
}

// The next batch of at most SP_SE of the `left` entries still due, in
// order: advances the cursor, sets `at` to the batch's first entry and
// returns its length (0 when none is left).  Every thread computes the
// same batches.
__device__ __forceinline__ int next_batch(const int32_t* __restrict__ cnt, int nch,
                                          int& c, int& j, int& left, size_t row0,
                                          size_t& at) {
  while (left > 0 && c < nch) {
    const int n = __ldg(cnt + c);
    if (j < n) {
      const int k = min(min(SP_SE, n - j), left);
      at = row0 + (size_t)c * LCHUNK + j;
      j += k;
      left -= k;
      return k;
    }
    ++c;
    j = 0;
  }
  return 0;
}

template <bool B16>
__device__ __forceinline__ void sparse_issue(
    uint32_t (*seg)[SP_TW], uint64_t* mseg, const int32_t* __restrict__ B,
    const int32_t* __restrict__ cols, const uint64_t* __restrict__ masks,
    size_t at, int k, int W, int w0, int t) {
  if (t < k) cp_async8(mseg + t, masks + at + t, 8);
  if (B16) {
    constexpr int PIECES = SP_TW / 4;    // 16-byte pieces of a segment
    for (int i = t; i < k * PIECES; i += SP_THREADS) {
      const int e = i / PIECES, p = i % PIECES;
      const int l = __ldg(cols + at + e);
      const int w = w0 + 4 * p;
      const bool ok = w < W;             // W % 4 == 0: all in or all out
      cp_async16(&seg[e][4 * p], ok ? B + (size_t)l * W + w : B, ok ? 16 : 0);
    }
  } else {
    const int w = w0 + t;
    const bool ok = w < W;
    for (int e = 0; e < k; ++e) {
      const int l = __ldg(cols + at + e);
      cp_async4(&seg[e][t], ok ? B + (size_t)l * W + w : B, ok ? 4 : 0);
    }
  }
}

template <bool B16>
__global__ void __launch_bounds__(SP_THREADS) packed_cols_sparse_kernel(
    const int32_t* __restrict__ B, const int32_t* __restrict__ cols,
    const uint64_t* __restrict__ masks, const int32_t* __restrict__ counts,
    int32_t* __restrict__ C, int M, int W, int NCH, int accumulate,
    long long sb, long long sc) {
  __shared__ __align__(16) uint32_t Cs[TM][SP_TW];
  __shared__ __align__(16) uint32_t ring[SP_NST][SP_SE][SP_TW];
  __shared__ __align__(16) uint64_t mring[SP_NST][SP_SE];
  const int t = threadIdx.x;
  // grid y runs over (copy, row block) pairs, GM row blocks a copy:
  // copy k reads B + k·sb and its own lists, and writes C + k·sc
  const int GM = (M + TM - 1) / TM;
  const int g = blockIdx.y % GM, w0 = blockIdx.x * SP_TW, m0 = g * TM;
  {
    const long long copy = blockIdx.y / GM;
    const long long chunks = (long long)GM * NCH;
    B += copy * sb;
    C += copy * sc;
    cols += copy * chunks * LCHUNK;
    masks += copy * chunks * LCHUNK;
    counts += copy * chunks;
  }
  const int splits = gridDim.z;
  const int32_t* cnt = counts + (size_t)g * NCH;
  const size_t row0 = (size_t)g * NCH * LCHUNK;
  // this block's share of the row block's list: entries [e0, e1)
  int total = 0;
  for (int c = 0; c < NCH; ++c) total += __ldg(cnt + c);
  const int e0 = (int)((long long)total * blockIdx.z / splits);
  const int e1 = (int)((long long)total * (blockIdx.z + 1) / splits);
  // nothing to OR in: C keeps its words (accumulating, or zeroed by the
  // launcher when the list is split)
  if (e0 == e1 && (accumulate || splits > 1)) return;
#pragma unroll 8
  for (int r = 0; r < TM; ++r) Cs[r][t] = 0u;
  int pc, pj, cc, cj;                    // producer and consumer cursors
  seek(cnt, NCH, e0, pc, pj);
  cc = pc;
  cj = pj;
  int pleft = e1 - e0, cleft = e1 - e0;
  size_t pat = 0, cat = 0;
#pragma unroll
  for (int s = 0; s < SP_NST - 1; ++s) {
    const int k = next_batch(cnt, NCH, pc, pj, pleft, row0, pat);
    sparse_issue<B16>(ring[s], mring[s], B, cols, masks, pat, k, W, w0, t);
    cp_async_commit();
  }
  for (int it = 0;; ++it) {
    {
      const int s = (it + SP_NST - 1) % SP_NST;   // consumed at it - 1
      const int k = next_batch(cnt, NCH, pc, pj, pleft, row0, pat);
      sparse_issue<B16>(ring[s], mring[s], B, cols, masks, pat, k, W, w0, t);
      cp_async_commit();
    }
    const int k = next_batch(cnt, NCH, cc, cj, cleft, row0, cat);
    cp_async_wait<SP_NST - 1>();
    __syncthreads();
    if (k == 0) break;                   // uniform: batches run in order
    const int s = it % SP_NST;
    for (int e = 0; e < k; ++e) {
      unsigned long long mk = mring[s][e];
      const uint32_t b = ring[s][e][t];
      while (mk) {
        const int r = __ffsll((long long)mk) - 1;
        mk &= mk - 1ull;
        Cs[r][t] |= b;
      }
    }
    __syncthreads();                     // before stage s is refilled
  }
  cp_async_wait<0>();
  const int w = w0 + t;
  if (w >= W) return;
  for (int r = 0; r < TM; ++r) {
    const int m = m0 + r;
    if (m >= M) break;
    const uint32_t v = Cs[r][t];
    int32_t* dst = C + (size_t)m * W + w;
    if (splits > 1) {
      if (v) atomicOr(dst, (int32_t)v);  // other shares OR into this word too
    } else if (!accumulate) {
      *dst = (int32_t)v;
    } else if (v) {
      *dst |= (int32_t)v;
    }
  }
}

// ---------------------------------------------------------------------------
// packed_cols_dense
//
// Replaces distel_tpu/ops/bitmatmul.py::_packed_cols_kernel
// (PackedColsMatmulPlan with skip_zero_tiles=False).
//
// Bound on this card: the bytes are A once, the B rows once and C once;
// the operations, counted as the reference's formulation does them, are
// 32·M·L·W int8 multiply-adds (2 ops each) at 1,979 TOP/s.  On operands
// whose tiles are live the operations bound it.
//
// Design: the reference's own formulation on the int8 tensor cores.  A
// block owns 64 rows x 8 words (256 bit columns) of C and walks L 64
// contraction rows at a time through a 3-stage cp.async ring holding
// the A tile (int8, straight from global memory) and the packed B tile.
// The B tile is unpacked in shared memory into int8 bit planes, K-major
// as mma's B operand wants it, plane-major (column p·8 + w is bit p of
// word w, as in the reference's _packed_cols_accumulate), with shifts
// and byte permutes: four words become 32 four-byte plane words.  Eight
// warps (2 x 4) each run mma.sync.m16n8k32.s32.s8.s8.s32 on a 32-row x
// 64-column tile with int32 accumulators (exact: a count is at most L).
// A k-tile whose staged A tile is all zero is skipped with one
// __syncthreads_or (its copies were already in flight).  Epilogue:
// threshold count > 0, fold each warp's 8 planes into words, OR the
// four warps' partial words in shared memory, write the 64 x 8 words.
// ---------------------------------------------------------------------------
constexpr int DTW = 8;          // words of C per block
constexpr int DN = 32 * DTW;    // bit columns per block
constexpr int DKT = 64;         // contraction rows per stage
constexpr int DNST = 3;         // stages in the ring
constexpr int DTHREADS = 256;
constexpr int DROW = DKT + 16;  // bytes per shared row of As and Bs (conflict-free fragments)

struct DenseSmem {
  alignas(16) int8_t As[DNST][TM][DROW];
  alignas(16) uint32_t Bp[DNST][DKT][DTW];
  alignas(16) int8_t Bs[DN][DROW];       // Bs[p*8 + w][k] = bit p of B[k0+k, w0+w]
  uint32_t Cw[TM][DTW];
};

template <bool A16, bool B16>
__device__ __forceinline__ void dense_issue(
    DenseSmem& sm, int s, const int8_t* __restrict__ A, const int32_t* __restrict__ B,
    int M, int L, int W, int m0, int w0, int k0, int tid) {
  {
    const int row = tid >> 2, piece = tid & 3;
    const int m = m0 + row, k = k0 + 16 * piece;
    int8_t* dst = &sm.As[s][row][16 * piece];
    if (A16) {
      const bool ok = m < M && k < L;    // L % 16 == 0: all in or all out
      cp_async16(dst, ok ? A + (size_t)m * L + k : A, ok ? 16 : 0);
    } else {
      uint32_t x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t v = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int kk = k + 4 * i + b;
          const uint32_t y = (m < M && kk < L) ? (uint8_t)A[(size_t)m * L + kk] : 0u;
          v |= y << (8 * b);
        }
        x[i] = v;
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(x[0], x[1], x[2], x[3]);
    }
  }
  if (B16) {
    if (tid < DKT * DTW / 4) {
      const int row = tid >> 1, piece = tid & 1;
      const int l = k0 + row, w = w0 + 4 * piece;
      const bool ok = l < L && w < W;    // W % 4 == 0
      cp_async16(&sm.Bp[s][row][4 * piece], ok ? B + (size_t)l * W + w : B, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < DKT * DTW; i += DTHREADS) {
      const int row = i / DTW, wd = i % DTW;
      const int l = k0 + row, w = w0 + wd;
      const bool ok = l < L && w < W;
      cp_async4(&sm.Bp[s][row][wd], ok ? B + (size_t)l * W + w : B, ok ? 4 : 0);
    }
  }
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// BATCH: blockIdx.x runs over (copy, word tile) pairs, ntw word tiles a
// copy, and copy b reads A + b·sa and B + b·sb and writes C + b·sc
// (strides in elements, 64-bit offsets) and, with n_rows, its own row
// count n_rows[b]: one launch for every copy of a batch.
template <bool A16, bool B16, bool BATCH>
__global__ void __launch_bounds__(DTHREADS) packed_cols_dense_kernel(
    const int8_t* __restrict__ A, const int32_t* __restrict__ B,
    int32_t* __restrict__ C, int M, int L, int W, int accumulate,
    long long sa, long long sb, long long sc, int ntw,
    const int* __restrict__ n_rows) {
  __shared__ DenseSmem sm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;        // mma fragment coordinates
  const int wm = warp & 1, wn = warp >> 1;      // warp tile: rows 32wm.., planes 8wn..
  int bx = blockIdx.x;
  int copy = 0;
  if (BATCH) {
    copy = bx / ntw;
    bx -= copy * ntw;
    A += copy * sa;
    B += copy * sb;
    C += copy * sc;
  }
  const int w0 = bx * DTW, m0 = blockIdx.y * TM;
  // rows past the card-held count are neither read nor written (the
  // wrapper then always accumulates, so C keeps them); a batch holds
  // one count a copy
  if (n_rows != nullptr) M = min(M, max(__ldg(n_rows + copy), 0));
  if (m0 >= M) return;
  for (int i = tid; i < TM * DTW; i += DTHREADS) sm.Cw[i / DTW][i % DTW] = 0u;
  int acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][nt][i] = 0;

  const int nk = (L + DKT - 1) / DKT;
#pragma unroll
  for (int s = 0; s < DNST - 1; ++s) {
    if (s < nk) dense_issue<A16, B16>(sm, s, A, B, M, L, W, m0, w0, s * DKT, tid);
    cp_async_commit();
  }
  // unpack mapping: lane -> (word, k-quad low), warp -> (k-quad high, plane half)
  const int uw = lane & 7, ukq = (lane >> 3) + 4 * (warp & 3), uq0 = 4 * (warp >> 2);
  for (int kt = 0; kt < nk; ++kt) {
    {
      const int nx = kt + DNST - 1;
      if (nx < nk) dense_issue<A16, B16>(sm, nx % DNST, A, B, M, L, W, m0, w0, nx * DKT, tid);
      cp_async_commit();
    }
    cp_async_wait<DNST - 1>();
    const int s = kt % DNST;
    const uint4 mine = *reinterpret_cast<const uint4*>(&sm.As[s][tid >> 2][16 * (tid & 3)]);
    // barrier for the whole stage, and the dead-tile test in one
    if (__syncthreads_or((mine.x | mine.y | mine.z | mine.w) != 0u)) {
      const uint32_t x0 = sm.Bp[s][4 * ukq + 0][uw], x1 = sm.Bp[s][4 * ukq + 1][uw];
      const uint32_t x2 = sm.Bp[s][4 * ukq + 2][uw], x3 = sm.Bp[s][4 * ukq + 3][uw];
#pragma unroll
      for (int qi = 0; qi < 4; ++qi) {
        const int q = uq0 + qi;
        // byte b of zj is bit q + 8b of xj
        const uint32_t z0 = (x0 >> q) & 0x01010101u, z1 = (x1 >> q) & 0x01010101u;
        const uint32_t z2 = (x2 >> q) & 0x01010101u, z3 = (x3 >> q) & 0x01010101u;
        const uint32_t t0 = __byte_perm(z0, z1, 0x5140), t1 = __byte_perm(z2, z3, 0x5140);
        const uint32_t t2 = __byte_perm(z0, z1, 0x7362), t3 = __byte_perm(z2, z3, 0x7362);
        // byte j of plane word = bit p of B row 4*ukq + j
        *reinterpret_cast<uint32_t*>(&sm.Bs[(q + 0) * DTW + uw][4 * ukq]) = __byte_perm(t0, t1, 0x5410);
        *reinterpret_cast<uint32_t*>(&sm.Bs[(q + 8) * DTW + uw][4 * ukq]) = __byte_perm(t0, t1, 0x7632);
        *reinterpret_cast<uint32_t*>(&sm.Bs[(q + 16) * DTW + uw][4 * ukq]) = __byte_perm(t2, t3, 0x5410);
        *reinterpret_cast<uint32_t*>(&sm.Bs[(q + 24) * DTW + uw][4 * ukq]) = __byte_perm(t2, t3, 0x7632);
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < DKT / 32; ++ks) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int r = 32 * wm + 16 * mi + g;
          const int kb = 32 * ks + 4 * t;
          a[mi][0] = *reinterpret_cast<const uint32_t*>(&sm.As[s][r][kb]);
          a[mi][1] = *reinterpret_cast<const uint32_t*>(&sm.As[s][r + 8][kb]);
          a[mi][2] = *reinterpret_cast<const uint32_t*>(&sm.As[s][r][kb + 16]);
          a[mi][3] = *reinterpret_cast<const uint32_t*>(&sm.As[s][r + 8][kb + 16]);
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int n = (8 * wn + nt) * DTW + g;
          const int kb = 32 * ks + 4 * t;
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&sm.Bs[n][kb]);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&sm.Bs[n][kb + 16]);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) mma_s8(acc[mi][nt], a[mi], b0, b1);
        }
      }
    }
    __syncthreads();                     // before Bs and stage s are rewritten
  }
  cp_async_wait<0>();
  // acc[mi][nt][2h + v]: row 32wm + 16mi + g + 8h, word 2t + v, plane 8wn + nt
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        uint32_t part = 0;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          part |= (acc[mi][nt][2 * h + v] > 0 ? 1u : 0u) << (8 * wn + nt);
        if (part) atomicOr(&sm.Cw[32 * wm + 16 * mi + g + 8 * h][2 * t + v], part);
      }
  __syncthreads();
  for (int i = tid; i < TM * DTW; i += DTHREADS) {
    const int row = i / DTW, wd = i % DTW;
    const int m = m0 + row, w = w0 + wd;
    if (m >= M || w >= W) continue;
    const uint32_t v = sm.Cw[row][wd];
    int32_t* dst = C + (size_t)m * W + w;
    if (!accumulate) *dst = (int32_t)v;
    else if (v) *dst |= (int32_t)v;
  }
}

}  // namespace

extern "C" {

// Row block and list chunk the wrapper must size the lists with.
int packed_cols_tile_m() { return TM; }
int packed_cols_list_chunk() { return LCHUNK; }

// Each entry point launches on `stream` and returns cudaGetLastError()
// (0 = launched); it neither synchronises nor allocates.

static int list_launch(const void* A, void* cols, void* masks, void* counts,
                       int NB, int M, int L, long long sa, const void* n_rows,
                       void* stream) {
  const int nch = (L + LCHUNK - 1) / LCHUNK;
  if (NB > 65535) return (int)cudaErrorInvalidConfiguration;
  dim3 grid(nch, (M + TM - 1) / TM, NB);
  cudaStream_t st = (cudaStream_t)stream;
  const int* n = (const int*)n_rows;
  if (L % 16 == 0 && (uintptr_t)A % 16 == 0 && sa % 16 == 0)
    packed_cols_list_kernel<true><<<grid, LIST_THREADS, 0, st>>>(
        (const int8_t*)A, (int32_t*)cols, (uint64_t*)masks, (int32_t*)counts, M, L, nch, n, sa);
  else
    packed_cols_list_kernel<false><<<grid, LIST_THREADS, 0, st>>>(
        (const int8_t*)A, (int32_t*)cols, (uint64_t*)masks, (int32_t*)counts, M, L, nch, n, sa);
  return (int)cudaGetLastError();
}

int packed_cols_list(const void* A, void* cols, void* masks, void* counts,
                     int M, int L, void* stream) {
  return list_launch(A, cols, masks, counts, 1, M, L, 0, nullptr, stream);
}

// packed_cols_list over rows m < *n_rows only (n_rows: one int32 on the
// card, read when the kernel starts).
int packed_cols_list_n(const void* A, void* cols, void* masks, void* counts,
                       int M, int L, const void* n_rows, void* stream) {
  return list_launch(A, cols, masks, counts, 1, M, L, 0, n_rows, stream);
}

// NB copies of packed_cols_list_n in one launch: copy b lists A + b·sa
// [M, L] (elements) over its rows m < n_rows[b] into the b-th list
// region, ceil(M / TM)·ceil(L / LCHUNK) chunks a copy, laid out one
// copy after another in cols, masks and counts.
int packed_cols_list_n_batched(const void* A, void* cols, void* masks,
                               void* counts, int NB, int M, int L,
                               long long sa, const void* n_rows,
                               void* stream) {
  return list_launch(A, cols, masks, counts, NB, M, L, sa, n_rows, stream);
}

// Lists with ceil(K / LCHUNK) chunks a row block (one when K == 0), as
// packed_cols_sparse reads them with L = K.
int packed_andor_list(const void* A, void* cols, void* masks, void* counts,
                      int M, int KW, int K, void* stream) {
  const int nch = K > 0 ? (K + LCHUNK - 1) / LCHUNK : 1;
  const int grid = (M + TM - 1) / TM;
  packed_andor_list_kernel<<<grid, AL_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)A, (int32_t*)cols, (uint64_t*)masks, (int32_t*)counts,
      M, KW, K, nch);
  return (int)cudaGetLastError();
}

static int sparse_launch(const void* B, const void* cols, const void* masks,
                         const void* counts, void* C, int NB, int M, int L,
                         int W, long long sb, long long sc, int accumulate,
                         void* stream) {
  const int nch = (L + LCHUNK - 1) / LCHUNK;
  const long long gm = (M + TM - 1) / TM;
  if (gm * NB > 65535) return (int)cudaErrorInvalidConfiguration;
  const long long tiles = (long long)((W + SP_TW - 1) / SP_TW) * gm * NB;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (long long)SP_TARGET_PER_SM * sms;
  const long long share = (want + tiles - 1) / tiles;
  const int splits = share < 1 ? 1 : share > SP_MAX_SPLITS ? SP_MAX_SPLITS : (int)share;
  cudaStream_t st = (cudaStream_t)stream;
  if (splits > 1 && !accumulate) {       // the shares OR into a zeroed C
    const size_t row = (size_t)M * W * sizeof(int32_t);
    const cudaError_t err =
        NB == 1 ? cudaMemsetAsync(C, 0, row, st)
                : cudaMemset2DAsync(C, (size_t)sc * sizeof(int32_t), 0, row, NB, st);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((W + SP_TW - 1) / SP_TW, (unsigned)(gm * NB), splits);
  if (W % 4 == 0 && (uintptr_t)B % 16 == 0 && sb % 4 == 0)
    packed_cols_sparse_kernel<true><<<grid, SP_THREADS, 0, st>>>(
        (const int32_t*)B, (const int32_t*)cols, (const uint64_t*)masks,
        (const int32_t*)counts, (int32_t*)C, M, W, nch, accumulate, sb, sc);
  else
    packed_cols_sparse_kernel<false><<<grid, SP_THREADS, 0, st>>>(
        (const int32_t*)B, (const int32_t*)cols, (const uint64_t*)masks,
        (const int32_t*)counts, (int32_t*)C, M, W, nch, accumulate, sb, sc);
  return (int)cudaGetLastError();
}

int packed_cols_sparse(const void* B, const void* cols, const void* masks,
                       const void* counts, void* C, int M, int L, int W,
                       int accumulate, void* stream) {
  return sparse_launch(B, cols, masks, counts, C, 1, M, L, W, 0, 0, accumulate,
                       stream);
}

// NB copies of packed_cols_sparse in one launch: copy b reads B + b·sb
// [L, W] and the b-th list region (as packed_cols_list_n_batched lays
// them out) and writes C + b·sc [M, W] (strides in elements).
int packed_cols_sparse_batched(const void* B, const void* cols,
                               const void* masks, const void* counts, void* C,
                               int NB, int M, int L, int W, long long sb,
                               long long sc, int accumulate, void* stream) {
  return sparse_launch(B, cols, masks, counts, C, NB, M, L, W, sb, sc,
                       accumulate, stream);
}

static int dense_launch(const void* A, const void* B, void* C, int M, int L,
                        int W, int accumulate, const void* n_rows, void* stream) {
  dim3 grid((W + DTW - 1) / DTW, (M + TM - 1) / TM);
  const int* n = (const int*)n_rows;
  const bool a16 = L % 16 == 0 && (uintptr_t)A % 16 == 0;
  const bool b16 = W % 4 == 0 && (uintptr_t)B % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* a = (const int8_t*)A;
  const int32_t* b = (const int32_t*)B;
  int32_t* c = (int32_t*)C;
  const int ntw = (int)grid.x;
  if (a16 && b16)
    packed_cols_dense_kernel<true, true, false><<<grid, DTHREADS, 0, st>>>(a, b, c, M, L, W, accumulate, 0, 0, 0, ntw, n);
  else if (a16)
    packed_cols_dense_kernel<true, false, false><<<grid, DTHREADS, 0, st>>>(a, b, c, M, L, W, accumulate, 0, 0, 0, ntw, n);
  else if (b16)
    packed_cols_dense_kernel<false, true, false><<<grid, DTHREADS, 0, st>>>(a, b, c, M, L, W, accumulate, 0, 0, 0, ntw, n);
  else
    packed_cols_dense_kernel<false, false, false><<<grid, DTHREADS, 0, st>>>(a, b, c, M, L, W, accumulate, 0, 0, 0, ntw, n);
  return (int)cudaGetLastError();
}

int packed_cols_dense(const void* A, const void* B, void* C, int M, int L,
                      int W, int accumulate, void* stream) {
  return dense_launch(A, B, C, M, L, W, accumulate, nullptr, stream);
}

// C |= A ⊙ B over rows m < *n_rows only (n_rows: one int32 on the card,
// read when the kernel starts); the other rows of C keep their words.
int packed_cols_dense_n(const void* A, const void* B, void* C, int M, int L,
                        int W, const void* n_rows, void* stream) {
  return dense_launch(A, B, C, M, L, W, 1, n_rows, stream);
}

// NB copies of the product in one launch: copy b is A + b·sa [M, L],
// B + b·sb [L, W] and C + b·sc [M, W] (strides in elements; each copy's
// rows contiguous).  The component plane's batched groups run every
// copy's CR4/CR6 window through it.
static int dense_batched_launch(const void* A, const void* B, void* C, int NB,
                                int M, int L, int W, long long sa, long long sb,
                                long long sc, int accumulate, const void* n_rows,
                                void* stream) {
  const long long ntw = (W + DTW - 1) / DTW;
  if (ntw * NB > 0x7fffffffLL || (M + TM - 1) / TM > 65535)
    return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned)(ntw * NB), (M + TM - 1) / TM);
  const bool a16 = L % 16 == 0 && (uintptr_t)A % 16 == 0 && sa % 16 == 0;
  const bool b16 = W % 4 == 0 && (uintptr_t)B % 16 == 0 && sb % 4 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int8_t* a = (const int8_t*)A;
  const int32_t* b = (const int32_t*)B;
  int32_t* c = (int32_t*)C;
  const int* n = (const int*)n_rows;
  if (a16 && b16)
    packed_cols_dense_kernel<true, true, true><<<grid, DTHREADS, 0, st>>>(a, b, c, M, L, W, accumulate, sa, sb, sc, (int)ntw, n);
  else if (a16)
    packed_cols_dense_kernel<true, false, true><<<grid, DTHREADS, 0, st>>>(a, b, c, M, L, W, accumulate, sa, sb, sc, (int)ntw, n);
  else if (b16)
    packed_cols_dense_kernel<false, true, true><<<grid, DTHREADS, 0, st>>>(a, b, c, M, L, W, accumulate, sa, sb, sc, (int)ntw, n);
  else
    packed_cols_dense_kernel<false, false, true><<<grid, DTHREADS, 0, st>>>(a, b, c, M, L, W, accumulate, sa, sb, sc, (int)ntw, n);
  return (int)cudaGetLastError();
}

int packed_cols_dense_batched(const void* A, const void* B, void* C, int NB,
                              int M, int L, int W, long long sa, long long sb,
                              long long sc, int accumulate, void* stream) {
  return dense_batched_launch(A, B, C, NB, M, L, W, sa, sb, sc, accumulate,
                              nullptr, stream);
}

// C[b] |= A[b] ⊙ B[b] over the rows m < n_rows[b] of each copy b
// (n_rows: NB int32 on the card, read when the kernel starts); the
// other rows keep their words.
int packed_cols_dense_n_batched(const void* A, const void* B, void* C, int NB,
                                int M, int L, int W, long long sa, long long sb,
                                long long sc, const void* n_rows,
                                void* stream) {
  return dense_batched_launch(A, B, C, NB, M, L, W, sa, sb, sc, 1, n_rows,
                              stream);
}

const char* packed_cols_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
