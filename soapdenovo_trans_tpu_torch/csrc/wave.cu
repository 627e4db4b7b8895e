// The Tour-Bus wave for Hopper, around its identity check: the wave's front
// (front_launch: from the arc table to the candidates' chains) and its back
// (back_launch: from the verdicts to the counts and the `failed` mask).
//
// front_launch replaces steps 1-4 of the jitted JAX _wave up to the
// identity check, soapdenovo_trans_tpu/graph/tourbus.py:140-219: the live
// arcs, the majority forest (prev[t] = the live predecessor of t with the
// highest coverage, the lowest from-edge on ties; a three-key sort there),
// the candidates (live non-forest arcs not in `failed`) and their order
// (the weakest coverage first, ties in arc row order; a two-key sort
// there, of which the wave reads the first cand_cap rows), then the walks.
// The port ran steps 1-2 as about 80 small launches around four stable
// radix sorts of the whole arc table.  Here:
//   forest_kernel, one thread an arc row: each live arc does one atomicMax
//     of the key (cvg_f + 2^31)·2^32 + (2^32 - 1 - from) into a forest
//     scratch of E uint64 at its to-edge, so the scratch holds the head the
//     sort would pick: the highest coverage, then the lowest from-edge (for
//     every int32 coverage and every from-edge below 2^31; the JAX package
//     keeps coverage in int32).  Block 0 zeroes the select's histograms and
//     the two counts.
//   cand_kernel, one thread a row: tree = (the head's from-edge == from),
//     cand = live & ~tree & ~failed; the row's biased coverage key and flag
//     go to the work buffer, n_cand is counted, and the top 11 bits of the
//     keys go to a histogram (in shared memory, one atomic a warp and bin).
//   select_kernel, twice, then count_kernel: a radix select of the
//     cand_cap-th key over three digits (11, 11 and 10 bits, so it is exact
//     for any int32 coverage): each block finds the digit of the last pass
//     from its global histogram (a 256-thread scan) and bins the next digit
//     of the candidates still in the bucket.  The first select_kernel also
//     writes prev from the forest scratch and zeroes it: the scratch is
//     empty again at the end of every wave, without a pass of its own.
//   count_kernel and scatter_kernel, a tile of 4,096 rows a block: the
//     rows below the threshold key, at it, and not candidates, counted by
//     tile, then compacted stably in row order (each block sums the counts
//     of the tiles before it): every candidate below the threshold and the
//     first cand_cap - (those) at it go to a pick list, and when there are
//     fewer than cand_cap candidates the first non-candidate rows in row
//     order fill the tail of cid_arc, as the two stable sorts leave them.
//   sort_kernel, one block: a bitonic sort of the at most cand_cap picked
//     (key, row) pairs in shared memory (1,024 x 8 B at the wave's cap)
//     gives cid_arc's head, cmask, u and t0.
//   chains_kernel, one thread a candidate row, the count n_back zeroed by
//     forest_kernel.
// For each candidate row c, with the forest prev (E,), the arc u -> t0 and
// cmask[c] (chains_kernel):
//   chain_a = t0, prev(t0), ... (m + 2 nodes), chain_b = u, prev(u), ...
//   (m + 1), a step from a node outside 0..E-1 giving -1;
//   the meeting point (i_s, j_s) is the first minimum of i + j over
//   chain_a[i] == chain_b[j] >= 0, i >= 1, in row-major order (argmin's
//   first-minimum rule: among equal sums the smaller i wins);
//   found0 = a meeting point exists & cmask (n_backtracked counts them);
//   maj[r] = chain_a[i_s - 1 - r] while that index is >= 1, mnr[r] =
//   chain_b[j_s - 1 - r] while it is >= 0, else -1 (all -1 unless found0);
//   tw_maj, tw_mnr their twins, ends = (s, t0, twin(s), twin(t0)) with
//   s = chain_a[i_s] (or -1), a twin of a node outside 0..E-1 being -1;
//   found = found0 & no minority-side node (mnr, tw_mnr) equals a
//   majority-side one (maj, tw_maj, ends) & no mnr[r] == tw_mnr[r] >= 0 &
//   some mnr >= 0 & some maj >= 0.
//
// back_launch replaces steps 5-6 of the JAX _wave, tourbus.py:221-325 from
// the verdicts on (the counts, the claims, the apply, the new arcs), plus
// the pinch's failed update at :349-356 (the mark itself at :354-356).
//   head_kernel, one block over the C rows: whether any row is ok, the
//     compared count, and the four counts (merged 0, overflow
//     max(n_cand - cand_cap, 0), backtracked, compared).  With no ok row
//     no candidate can merge (the least ok (rank, c) would win every edge
//     it claims), so it marks failed[cid_arc[c]] for every cmask row and
//     closes the gate: the three kernels after it return at once, and
//     cvg2, deleted2 and the new arc rows are left undefined (no caller
//     reads them when nothing merged: the JAX pinch, WaveProgram.apply).
//   claim_kernel, apply_kernel, arcs_kernel behind the gate, n_merged
//     going to counts[0] and the dropped rows to counts[4]; each ok
//     candidate that holds the least (rank, candidate) of every edge it
//     claims wins, rank the minority path's coverage; each winner
//     deletes its minority nodes and their twins, adds their coverage onto
//     the majority node that covers each one's midpoint (the last majority
//     node if none does) and on that node's twin, and maps them onto it
//     (remap; -1 where the path has no majority node) and onto itself
//     (owner, written at the same nodes).  arcs_kernel, one thread a row:
//     a row with a minority node at either end is dropped where its other
//     end is an edge the same winner claims (the bubble's own fork, join
//     and path arcs and their twins: Claims::holds on the winner's list),
//     where the node has no cover, and where the remapped row would not
//     join (to_node[from] != from_node[to]); the others are remapped, the
//     self-loops the remap makes dropped (a row whose original from and to
//     were equal is kept unless the rule drops it); cvg2 clamped into [0,
//     MAX_EDGE_COV].  The JAX wave remaps every row of a minority node and
//     drops only those self-loops, which can join a fork to a cover or a
//     cover to the join past a majority node.
// The back writes new buffers, not the pinch's cvg and deleted in place:
// applying in place would save WaveProgram.apply two copies in productive
// waves only (721 of 7,968 in the 500k-pair stage), and the win test reads
// the coverage of every ok row's minority nodes while the winners add
// onto their majority nodes, which another ok row may list.  A cooperative
// launch is not used: three dependent launches that return at once in an
// unproductive wave capture into the wave's CUDA graph as they are.
//
// Bound on this card: the bytes.  The front must read the arc rows, their
// mult and failed (25·A B), deleted and the coverage of the edges the rows
// name (up to 9·E), the twins of the path nodes and ends, and write its
// outputs (about 32·C·m + 66·C B): at the 500k-pair stage's A = 714,984,
// E = 551,705 about 23 MB, 7 us at 3.35 TB/s.  Its passes read the arc
// rows twice (forest_kernel, cand_kernel) and 5 B a row four times after
// (the selects, the count, the scatter), and the forest scratch and prev
// once each (24 B an edge): about 70 MB.  The back, in a wave where no row
// is ok (91% of the 500k-pair stage's waves), must read ok, compared and
// cmask (3 B a row) and cid_arc of the rows it marks: a few KB, one block
// and three empty launches, so the launches set its time.  In a productive
// wave it moves about 18·E + 48·A B, and the end nodes of the rows it
// remaps.
//
// Design.  chains_kernel: one thread a candidate, 32 candidates a block
// (one warp), the two walks interleaved (their loads independent), each
// thread's chains, path sides and twins in shared memory ([slot][thread],
// (6m + 7)·8 B a thread: 47,872 B a block at m = 30, so no attribute is
// needed); n_backtracked is one ballot and one atomicAdd a block.  The
// grid-wide passes of the front and the back are grid-stride loops of at
// most GRID_CAP blocks.  The claim key rank·2^32 + c keeps the order of
// (rank, c) while |rank| < 2^31: the ranks of an EdgeGraph are sums of at
// most 30 coverages of at most MAX_EDGE_COV = 16,000, which the clamp of
// every wave keeps.  The claim scratch (E int64, EMPTY between calls) and
// the forest scratch (E uint64, 0 between calls) are allocated once a card
// by the wrappers, outside any capture, and kept with the wave's graph.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_M = 30;          // node slots a path (-M 3: MAXNODELENGTH)
constexpr int CHAIN_ROWS = 32;     // candidates a block of chains_kernel
constexpr int APPLY_ROWS = 32;     // candidates a block of apply_kernel
constexpr int THREADS = 256;       // threads a block of the grid-wide passes
constexpr int WARPS = THREADS / 32;
constexpr int GRID_CAP = 1024;     // blocks of a grid-stride pass
constexpr int BINS = 2048;         // bins of a radix-select digit (11 bits)
constexpr int TILE = THREADS * 16; // arc rows a block of count/scatter
constexpr int MAX_CAND = 4096;     // candidate rows sort_kernel takes
constexpr int SORT_THREADS = 1024;
constexpr int HEAD_THREADS = 1024;
constexpr long long EMPTY = LLONG_MAX;  // an unclaimed scratch entry
constexpr long long MAX_EDGE_COV = 16000;
constexpr unsigned FULL = 0xFFFFFFFFu;
typedef unsigned long long u64;

__device__ __forceinline__ long long gather_or(const long long* x,
                                               long long n, long long i,
                                               long long fill) {
  return i >= 0 && i < n ? __ldg(x + i) : fill;
}

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  const long long q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__global__ void chains_kernel(
    const long long* __restrict__ prev, const long long* __restrict__ u,
    const long long* __restrict__ t0, const unsigned char* __restrict__ cmask,
    const long long* __restrict__ twin, long long* __restrict__ maj,
    long long* __restrict__ mnr, long long* __restrict__ tw_maj,
    long long* __restrict__ tw_mnr, long long* __restrict__ s_node,
    long long* __restrict__ ends, unsigned char* __restrict__ found,
    u64* __restrict__ n_back, long long c, long long e, int m) {
  extern __shared__ long long smem[];
  const int tid = threadIdx.x;
  const long long row = (long long)blockIdx.x * CHAIN_ROWS + tid;
  const int la = m + 2, lb = m + 1, na = 2 * m + 4, nb = 2 * m;
  long long* ca = smem;                    // chain_a, [la][CHAIN_ROWS]
  long long* cb = ca + la * CHAIN_ROWS;    // chain_b, [lb][CHAIN_ROWS]
  long long* as = cb + lb * CHAIN_ROWS;    // maj, tw_maj, ends: [na][...]
  long long* bs = as + na * CHAIN_ROWS;    // mnr, tw_mnr: [nb][...]
#define CA(k) ca[(k) * CHAIN_ROWS + tid]
#define CB(k) cb[(k) * CHAIN_ROWS + tid]
#define AS(k) as[(k) * CHAIN_ROWS + tid]
#define BS(k) bs[(k) * CHAIN_ROWS + tid]
  bool hit = false;
  if (row < c) {
    // the two walks side by side: each step's two loads are independent
    long long xa = t0[row], xb = u[row];
    CA(0) = xa;
    CB(0) = xb;
    for (int k = 1; k < la; ++k) {
      CA(k) = xa = gather_or(prev, e, xa, -1);
      if (k < lb) CB(k) = xb = gather_or(prev, e, xb, -1);
    }

    // the first minimum of i + j in row-major order: i ascending, the
    // least j for each i, a later i only if strictly less
    int best = INT_MAX, bi = 0, bj = 0;
    for (int i = 1; i < la && i < best; ++i) {
      const long long xi = CA(i);
      if (xi < 0) continue;
      for (int j = 0; j < lb; ++j) {
        if (CB(j) == xi) {
          if (i + j < best) best = i + j, bi = i, bj = j;
          break;
        }
      }
    }
    const bool fnd = best != INT_MAX && cmask[row] && bi - 1 <= m && bj <= m;
    hit = fnd;
    const long long s = fnd ? CA(bi) : -1;
    const long long t = t0[row];

    bool any_a = false, any_b = false, clash = false;
    for (int r = 0; r < m; ++r) {
      const int ia = bi - 1 - r, ib = bj - 1 - r;
      const long long va = fnd && ia >= 1 ? CA(ia) : -1;
      const long long vb = fnd && ib >= 0 ? CB(ib) : -1;
      const long long ta = gather_or(twin, e, va, -1);
      const long long tb = gather_or(twin, e, vb, -1);
      maj[row * m + r] = va;
      mnr[row * m + r] = vb;
      tw_maj[row * m + r] = ta;
      tw_mnr[row * m + r] = tb;
      AS(r) = va, AS(m + r) = ta, BS(r) = vb, BS(m + r) = tb;
      any_a |= va >= 0;
      any_b |= vb >= 0;
      clash |= vb == tb && vb >= 0;  // a palindrome in the minority path
    }
    const long long end[4] = {s, t, gather_or(twin, e, s, -1),
                              gather_or(twin, e, t, -1)};
    for (int k = 0; k < 4; ++k) {
      AS(2 * m + k) = end[k];
      ends[row * 4 + k] = end[k];
    }
    s_node[row] = s;
    for (int p = 0; p < nb && !clash; ++p) {
      const long long y = BS(p);
      if (y < 0) continue;
      for (int q = 0; q < na; ++q) clash |= AS(q) == y;
    }
    found[row] = fnd && !clash && any_a && any_b;
  }
#undef CA
#undef CB
#undef AS
#undef BS
  const unsigned votes = __ballot_sync(FULL, hit);
  if (tid == 0 && votes) atomicAdd(n_back, (u64)__popc(votes));
}

// ---- the front: forest, candidates, select, compaction, sort -------------

// The radix select's state after a digit (written by block 0 of the pass
// that finds the digit, read by the passes after it).
struct Sel {
  u64 thresh;        // last digit: the threshold key (2^32: every candidate)
  u64 lt;            // candidates whose key lies below the bucket
  u64 need;          // last digit: rows taken at the threshold key
  unsigned prefix;   // the digits found so far
  unsigned rank;     // the rank (1-based) still sought within the bucket
  unsigned all;      // n_cand <= C: every candidate is taken
  unsigned pad;
};

// The front's work buffer, carved from one allocation.
struct FrontWork {
  unsigned* hist;          // 3 x BINS: one histogram a digit
  Sel* sel;                // 3: after each digit
  unsigned* tiles;         // 3 a tile: rows below, at, not candidates
  u64* picked;             // C: the picked (key, row) pairs
  unsigned* ckey;          // A: the rows' biased coverage keys
  unsigned char* cflag;    // A: the rows' candidate flags
  long long* prev;         // E: the forest
  long long* s_node;       // C: the forks (chains_kernel writes them)
};

size_t align256(size_t x) { return (x + 255) & ~(size_t)255; }

long long tiles_of(long long a) { return (a + TILE - 1) / TILE; }

// Carves the work buffer at `base` (nullptr: sizes only); returns its bytes.
size_t carve(char* base, long long a, long long e, long long c,
             FrontWork* w) {
  size_t off = 0;
  auto take = [&](size_t bytes) {
    char* p = base ? base + off : nullptr;
    off += align256(bytes);
    return p;
  };
  w->hist = reinterpret_cast<unsigned*>(take(3 * BINS * sizeof(unsigned)));
  w->sel = reinterpret_cast<Sel*>(take(3 * sizeof(Sel)));
  w->tiles = reinterpret_cast<unsigned*>(
      take(3 * tiles_of(a) * sizeof(unsigned)));
  w->picked = reinterpret_cast<u64*>(take(c * sizeof(u64)));
  w->ckey = reinterpret_cast<unsigned*>(take(a * sizeof(unsigned)));
  w->cflag = reinterpret_cast<unsigned char*>(take(a));
  w->prev = reinterpret_cast<long long*>(take(e * sizeof(long long)));
  w->s_node = reinterpret_cast<long long*>(take(c * sizeof(long long)));
  return off;
}

// An int32 coverage as an unsigned key of the same order.
__device__ __forceinline__ unsigned bias(long long v) {
  return (unsigned)(v + 2147483648LL);
}

__device__ __forceinline__ u64 forest_key(long long cv, long long f) {
  return ((u64)bias(cv) << 32) | (u64)(FULL - (unsigned)f);
}

// The from-edge of a forest scratch entry (-1: no live predecessor).
__device__ __forceinline__ long long forest_from(u64 key) {
  return key ? (long long)(FULL - (unsigned)(key & FULL)) : -1;
}

__device__ __forceinline__ bool live_edge(const unsigned char* deleted,
                                          long long n_live, long long x) {
  return x >= 0 && x < n_live && !deleted[x];
}

// Arc row i's from- and to-edge when it is a live arc (varc), else false.
__device__ __forceinline__ bool live_arc(
    const long long* from_ed, const long long* to_ed, const long long* mult,
    const unsigned char* deleted, long long n_live, long long i,
    long long* f, long long* t) {
  *f = from_ed[i];
  *t = to_ed[i];
  return mult[i] > 0 && live_edge(deleted, n_live, *f) &&
         live_edge(deleted, n_live, *t);
}

// Adds 1 at `bin` of a shared histogram for each lane with `on`, one
// atomic a warp and bin; every lane of the warp calls it.
__device__ __forceinline__ void hist_add(unsigned* h, unsigned bin, bool on) {
  const unsigned active = __ballot_sync(FULL, on);
  if (on) {
    const unsigned peers = __match_any_sync(active, bin);
    if ((int)(threadIdx.x & 31) == __ffs(peers) - 1)
      atomicAdd(h + bin, (unsigned)__popc(peers));
  }
}

// Adds a block's shared histogram into the global one.
__device__ __forceinline__ void hist_flush(const unsigned* h, unsigned* g) {
  __syncthreads();
  for (int k = threadIdx.x; k < BINS; k += blockDim.x)
    if (h[k]) atomicAdd(g + k, h[k]);
}

// The bin of `bins` that holds the rank-th (1-based, rank <= the total)
// entry of histogram `hist`, and the entries before that bin.  Every
// thread of a THREADS block calls it.
__device__ void pick_bin(const unsigned* hist, int bins, unsigned rank,
                         unsigned* bin, unsigned* before) {
  __shared__ unsigned warp_sum[WARPS];
  __shared__ unsigned out[2];
  const int tid = threadIdx.x, per = bins / THREADS;
  unsigned local = 0;
  for (int k = 0; k < per; ++k) local += hist[tid * per + k];
  unsigned incl = local;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(FULL, incl, o);
    if ((tid & 31) >= o) incl += y;
  }
  if ((tid & 31) == 31) warp_sum[tid >> 5] = incl;
  __syncthreads();
  unsigned excl = incl - local;
  for (int w = 0; w < (tid >> 5); ++w) excl += warp_sum[w];
  if (excl < rank && rank <= excl + local) {
    unsigned run = excl;
    for (int k = 0; k < per; ++k) {
      const unsigned h = hist[tid * per + k];
      if (run + h >= rank) {
        out[0] = tid * per + k;
        out[1] = run;
        break;
      }
      run += h;
    }
  }
  __syncthreads();
  *bin = out[0];
  *before = out[1];
}

// Ranks of three flags over a block (exclusive, in thread order) and their
// totals; every thread of a THREADS block calls it.
__device__ __forceinline__ void rank3(const bool (&f)[3], unsigned (&r)[3],
                                      unsigned (&tot)[3]) {
  __shared__ unsigned ws[WARPS][3];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned b[3];
  for (int k = 0; k < 3; ++k) b[k] = __ballot_sync(FULL, f[k]);
  if (lane == 0)
    for (int k = 0; k < 3; ++k) ws[warp][k] = __popc(b[k]);
  __syncthreads();
  for (int k = 0; k < 3; ++k) {
    unsigned before = 0, all = 0;
    for (int w = 0; w < WARPS; ++w) {
      before += w < warp ? ws[w][k] : 0;
      all += ws[w][k];
    }
    r[k] = before + __popc(b[k] & ((1u << lane) - 1));
    tot[k] = all;
  }
  __syncthreads();
}

__global__ void front_forest_kernel(
    const long long* __restrict__ from_ed, const long long* __restrict__ to_ed,
    const long long* __restrict__ mult, const unsigned char* __restrict__ deleted,
    const long long* __restrict__ cvg, u64* __restrict__ forest,
    unsigned* __restrict__ hist, u64* __restrict__ n_cand,
    u64* __restrict__ n_back, long long a, long long n_live) {
  if (blockIdx.x == 0) {
    for (int k = threadIdx.x; k < 3 * BINS; k += blockDim.x) hist[k] = 0;
    if (threadIdx.x == 0) *n_cand = 0, *n_back = 0;
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < a;
       i += stride) {
    long long f, t;
    if (live_arc(from_ed, to_ed, mult, deleted, n_live, i, &f, &t))
      atomicMax(forest + t, forest_key(cvg[f], f));
  }
}

__global__ void front_cand_kernel(
    const long long* __restrict__ from_ed, const long long* __restrict__ to_ed,
    const long long* __restrict__ mult, const unsigned char* __restrict__ deleted,
    const long long* __restrict__ cvg, const unsigned char* __restrict__ failed,
    const u64* __restrict__ forest, unsigned* __restrict__ ckey,
    unsigned char* __restrict__ cflag, unsigned* __restrict__ hist0,
    u64* __restrict__ n_cand, long long a, long long n_live) {
  __shared__ unsigned h[BINS];
  __shared__ unsigned block_n;
  for (int k = threadIdx.x; k < BINS; k += blockDim.x) h[k] = 0;
  if (threadIdx.x == 0) block_n = 0;
  __syncthreads();
  unsigned mine = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long base = (long long)blockIdx.x * blockDim.x; base < a;
       base += stride) {  // the same trips for every thread of the block
    const long long i = base + threadIdx.x;
    bool cand = false;
    unsigned key = 0;
    if (i < a) {
      long long f, t;
      if (live_arc(from_ed, to_ed, mult, deleted, n_live, i, &f, &t)) {
        cand = forest_from(forest[t]) != f && !failed[i];
        key = bias(cvg[f]);
      }
      ckey[i] = key;
      cflag[i] = cand;
    }
    hist_add(h, key >> 21, cand);
    mine += cand;
  }
  mine = __reduce_add_sync(FULL, mine);
  if ((threadIdx.x & 31) == 0 && mine) atomicAdd(&block_n, mine);
  hist_flush(h, hist0);
  if (threadIdx.x == 0 && block_n) atomicAdd(n_cand, (u64)block_n);
}

// Digit `level` of the select (1 or 2): finds the digit of the pass
// before from its histogram, bins the next digit of the candidates in the
// bucket.  Level 1 also writes prev from the forest scratch and zeroes it.
__global__ void front_select_kernel(
    int level, const unsigned* __restrict__ ckey,
    const unsigned char* __restrict__ cflag, unsigned* __restrict__ hist,
    Sel* __restrict__ sel, const u64* __restrict__ n_cand,
    u64* __restrict__ forest, long long* __restrict__ prev, long long a,
    long long e, long long c) {
  __shared__ unsigned h[BINS];
  for (int k = threadIdx.x; k < BINS; k += blockDim.x) h[k] = 0;
  Sel s;
  if (level == 1) {
    s = Sel{0, 0, 0, 0, (unsigned)c, *n_cand <= (u64)c || c == 0, 0};
  } else {
    s = sel[0];
  }
  if (!s.all) {
    unsigned bin, before;
    pick_bin(hist + (level - 1) * BINS, BINS, s.rank, &bin, &before);
    s.prefix = (s.prefix << 11) | bin;
    s.rank -= before;
    s.lt += before;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) sel[level - 1] = s;
  __syncthreads();
  const int shift = level == 1 ? 21 : 10;  // the bucket's digits
  const long long n = level == 1 ? (a > e ? a : e) : (s.all ? 0 : a);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long base = (long long)blockIdx.x * blockDim.x; base < n;
       base += stride) {
    const long long i = base + threadIdx.x;
    bool in = false;
    unsigned key = 0;
    if (i < a && !s.all) {
      key = ckey[i];
      in = cflag[i] && (key >> shift) == s.prefix;
    }
    hist_add(h, level == 1 ? (key >> 10) & (BINS - 1) : key & 1023u, in);
    if (level == 1 && i < e) {
      prev[i] = forest_from(forest[i]);
      forest[i] = 0;  // empty for the next wave
    }
  }
  hist_flush(h, hist + level * BINS);
}

// The last digit and the threshold, then each tile's counts of the rows
// below it, at it and not candidates.
__global__ void front_count_kernel(const unsigned* __restrict__ ckey,
                                   const unsigned char* __restrict__ cflag,
                                   const unsigned* __restrict__ hist,
                                   Sel* __restrict__ sel,
                                   const u64* __restrict__ n_cand,
                                   unsigned* __restrict__ tiles, long long a,
                                   long long c) {
  Sel s = sel[1];
  if (s.all) {
    s.thresh = 1ull << 32;
    s.lt = *n_cand;
    s.need = 0;
  } else {
    unsigned bin, before;
    pick_bin(hist + 2 * BINS, 1024, s.rank, &bin, &before);
    s.thresh = ((u64)s.prefix << 10) | bin;
    s.lt += before;
    s.need = (u64)c - s.lt;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) sel[2] = s;
  const long long lo = (long long)blockIdx.x * TILE;
  const long long hi = lo + TILE < a ? lo + TILE : a;
  unsigned tot_all[3] = {0, 0, 0};
  for (long long base = lo; base < hi; base += THREADS) {
    const long long i = base + threadIdx.x;
    const bool in = i < hi, cand = in && cflag[i];
    const u64 key = in ? ckey[i] : 0;
    const bool f[3] = {cand && key < s.thresh, cand && key == s.thresh,
                       in && !cand};
    unsigned r[3], tot[3];
    rank3(f, r, tot);
    for (int k = 0; k < 3; ++k) tot_all[k] += tot[k];
  }
  if (threadIdx.x == 0)
    for (int k = 0; k < 3; ++k) tiles[blockIdx.x * 3 + k] = tot_all[k];
}

// The stable compaction: the picked (key, row) pairs and cid_arc's tail.
__global__ void front_scatter_kernel(
    const unsigned* __restrict__ ckey, const unsigned char* __restrict__ cflag,
    const Sel* __restrict__ sel, const unsigned* __restrict__ tiles,
    const u64* __restrict__ n_cand, u64* __restrict__ picked,
    long long* __restrict__ cid_arc, unsigned char* __restrict__ cmask,
    long long* __restrict__ u, long long* __restrict__ t0, long long a,
    long long c) {
  __shared__ u64 pre[3];
  const Sel s = sel[2];
  if (threadIdx.x < 3) pre[threadIdx.x] = 0;
  __syncthreads();
  u64 mine[3] = {0, 0, 0};
  for (long long q = threadIdx.x; q < blockIdx.x; q += blockDim.x)
    for (int k = 0; k < 3; ++k) mine[k] += tiles[q * 3 + k];
  for (int k = 0; k < 3; ++k) {
    for (int o = 16; o > 0; o >>= 1)
      mine[k] += __shfl_down_sync(FULL, mine[k], o);
    if ((threadIdx.x & 31) == 0 && mine[k]) atomicAdd(&pre[k], mine[k]);
  }
  __syncthreads();
  u64 at[3] = {pre[0], pre[1], pre[2]};
  const u64 n_sel = *n_cand < (u64)c ? *n_cand : (u64)c;
  const long long lo = (long long)blockIdx.x * TILE;
  const long long hi = lo + TILE < a ? lo + TILE : a;
  for (long long base = lo; base < hi; base += THREADS) {
    const long long i = base + threadIdx.x;
    const bool in = i < hi, cand = in && cflag[i];
    const u64 key = in ? ckey[i] : 0;
    const bool f[3] = {cand && key < s.thresh, cand && key == s.thresh,
                       in && !cand};
    unsigned r[3], tot[3];
    rank3(f, r, tot);
    if (f[0]) picked[at[0] + r[0]] = key << 32 | (u64)i;
    if (f[1] && at[1] + r[1] < s.need)
      picked[s.lt + at[1] + r[1]] = key << 32 | (u64)i;
    if (f[2] && n_sel + at[2] + r[2] < (u64)c) {
      const u64 pos = n_sel + at[2] + r[2];
      cid_arc[pos] = i;
      cmask[pos] = 0;
      u[pos] = t0[pos] = -1;
    }
    for (int k = 0; k < 3; ++k) at[k] += tot[k];
  }
}

// One block: the picked pairs in (key, row) order, then the head of
// cid_arc, cmask, u and t0.
__global__ void front_sort_kernel(const u64* __restrict__ picked,
                                  const u64* __restrict__ n_cand,
                                  const long long* __restrict__ from_ed,
                                  const long long* __restrict__ to_ed,
                                  long long* __restrict__ cid_arc,
                                  unsigned char* __restrict__ cmask,
                                  long long* __restrict__ u,
                                  long long* __restrict__ t0, long long c) {
  __shared__ u64 s[MAX_CAND];
  const int tid = threadIdx.x;
  const int n = (int)(*n_cand < (u64)c ? *n_cand : (u64)c);
  int p = 1;
  while (p < n) p <<= 1;
  for (int k = tid; k < p; k += blockDim.x) s[k] = k < n ? picked[k] : ~0ull;
  __syncthreads();
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int x = tid; x < p; x += blockDim.x) {
        const int y = x ^ j;
        if (y > x) {
          const u64 vx = s[x], vy = s[y];
          if ((vx > vy) == ((x & k) == 0)) s[x] = vy, s[y] = vx;
        }
      }
      __syncthreads();
    }
  }
  for (int k = tid; k < n; k += blockDim.x) {
    const long long row = (long long)(s[k] & FULL);
    cid_arc[k] = row;
    cmask[k] = 1;
    u[k] = from_ed[row];
    t0[k] = to_ed[row];
  }
}

// ---- the back: claims, apply, arcs ---------------------------------------

// A candidate's claims: maj, tw_maj, mnr, tw_mnr (m each), then ends (4).
struct Claims {
  const long long *maj, *tw_maj, *mnr, *tw_mnr, *ends;
  int m;

  __device__ __forceinline__ long long at(long long c, int k) const {
    if (k < m) return maj[c * m + k];
    if ((k -= m) < m) return tw_maj[c * m + k];
    if ((k -= m) < m) return mnr[c * m + k];
    if ((k -= m) < m) return tw_mnr[c * m + k];
    return ends[c * 4 + k - m];
  }
  __device__ __forceinline__ int count() const { return 4 * m + 4; }
  // whether candidate c claims edge x (no edge for x < 0)
  __device__ __forceinline__ bool holds(long long c, long long x) const {
    if (c < 0 || x < 0) return false;
    for (int k = 0; k < count(); ++k)
      if (at(c, k) == x) return true;
    return false;
  }
};

// rank·2^32 + c, rank the coverage of the minority path's nodes
__device__ __forceinline__ long long claim_key(const Claims& cl,
                                               const long long* cvg,
                                               long long e, long long c) {
  long long rank = 0;
  for (int r = 0; r < cl.m; ++r)
    rank += gather_or(cvg, e, cl.mnr[c * cl.m + r], 0);
  return rank * 4294967296LL + c;
}

// A gate of 0 (the back's head found no ok row) skips a kernel.
__device__ __forceinline__ bool closed(const int* gate) {
  return *gate == 0;
}

__global__ void back_head_kernel(
    const unsigned char* __restrict__ ok,
    const unsigned char* __restrict__ compared,
    const unsigned char* __restrict__ cmask,
    const long long* __restrict__ cid_arc, const long long* __restrict__ n_cand,
    const long long* __restrict__ n_back, unsigned char* __restrict__ failed,
    long long* __restrict__ counts, int* __restrict__ gate, long long c,
    long long a, long long cand_cap) {
  __shared__ int any_ok;
  __shared__ u64 n_cmp;
  if (threadIdx.x == 0) any_ok = 0, n_cmp = 0;
  __syncthreads();
  bool got = false;
  unsigned mine = 0;
  for (long long k = threadIdx.x; k < c; k += blockDim.x) {
    got |= ok[k] != 0;
    mine += compared[k] != 0;
  }
  if (__any_sync(FULL, got) && (threadIdx.x & 31) == 0) any_ok = 1;
  mine = __reduce_add_sync(FULL, mine);
  if ((threadIdx.x & 31) == 0 && mine) atomicAdd(&n_cmp, (u64)mine);
  __syncthreads();
  if (!any_ok) {  // nothing merges: retire the examined candidates
    for (long long k = threadIdx.x; k < c; k += blockDim.x) {
      const long long x = cid_arc[k];
      if (cmask[k] && !ok[k] && x >= 0 && x < a) failed[x] = 1;
    }
  }
  if (threadIdx.x == 0) {
    const long long over = *n_cand - cand_cap;
    counts[0] = 0;
    counts[1] = over > 0 ? over : 0;
    counts[2] = *n_back;
    counts[3] = (long long)n_cmp;
    counts[4] = 0;
    *gate = any_ok;
  }
}

__global__ void claim_kernel(Claims cl, const unsigned char* __restrict__ ok,
                             const long long* __restrict__ cvg,
                             const unsigned char* __restrict__ deleted,
                             long long* __restrict__ claim,
                             long long* __restrict__ cvg2,
                             unsigned char* __restrict__ deleted2,
                             long long* __restrict__ remap,
                             const int* __restrict__ gate, long long c,
                             long long e) {
  if (closed(gate)) return;
  const long long n = e > c ? e : c;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (i < e) {
      cvg2[i] = cvg[i];
      deleted2[i] = deleted[i];
      remap[i] = i;
    }
    if (i < c && ok[i]) {
      const long long key = claim_key(cl, cvg, e, i);
      for (int k = 0; k < cl.count(); ++k) {
        const long long x = cl.at(i, k);
        if (x >= 0 && x < e) atomicMin(claim + x, key);
      }
    }
  }
}

__global__ void apply_kernel(Claims cl, const unsigned char* __restrict__ ok,
                             const long long* __restrict__ len_a,
                             const long long* __restrict__ len_b,
                             const long long* __restrict__ cvg,
                             const long long* __restrict__ length,
                             const long long* __restrict__ twin,
                             const long long* __restrict__ claim,
                             long long* __restrict__ cvg2,
                             unsigned char* __restrict__ deleted2,
                             long long* __restrict__ remap,
                             int* __restrict__ owner,
                             u64* __restrict__ n_merged,
                             const int* __restrict__ gate, long long c,
                             long long e) {
  if (closed(gate)) return;
  const long long i = (long long)blockIdx.x * APPLY_ROWS + threadIdx.x;
  if (i >= c || !ok[i]) return;
  const long long key = claim_key(cl, cvg, e, i);
  for (int k = 0; k < cl.count(); ++k) {
    const long long x = cl.at(i, k);
    if (x >= 0 && x < e && claim[x] != key) return;  // another's edge
  }
  atomicAdd(n_merged, 1ull);
  const int m = cl.m;
  const long long* mj = cl.maj + i * m;
  const long long* mn = cl.mnr + i * m;
  const long long* tmn = cl.tw_mnr + i * m;
  for (int r = 0; r < m; ++r) {
    if (mn[r] >= 0 && mn[r] < e) deleted2[mn[r]] = 1;
    if (tmn[r] >= 0 && tmn[r] < e) deleted2[tmn[r]] = 1;
  }

  // positional cover: each minority node's midpoint, scaled to the
  // majority path, picks the majority node whose span holds it
  int live_a = 0;
  for (int k = 0; k < m; ++k) live_a += mj[k] >= 0;
  const long long last = mj[live_a > 0 ? live_a - 1 : 0];
  const long long na = len_a[i], nb = len_b[i];
  long long cover[MAX_M];
  long long cum_b = 0;
  for (int r = 0; r < m; ++r) {
    const long long lb = gather_or(length, e, mn[r], 0);
    const long long mid = cum_b + floor_div(lb, 2);
    cum_b += lb;
    const long long scale = nb > 0 ? floor_div(mid * na, nb) : 0;
    long long cv = last, cum_a = 0;
    for (int k = 0; k < m; ++k) {
      const long long ln = gather_or(length, e, mj[k], 0);
      if (mj[k] >= 0 && scale >= cum_a && scale < cum_a + ln) {
        cv = mj[k];
        break;
      }
      cum_a += ln;
    }
    cover[r] = mn[r] >= 0 ? cv : -1;
  }
  for (int r = 0; r < m; ++r) {
    const long long cv = cover[r], tcv = gather_or(twin, e, cv, -1);
    if (cv >= 0 && cv < e)
      atomicAdd(reinterpret_cast<u64*>(cvg2 + cv),
                (u64)gather_or(cvg, e, mn[r], 0));
    if (tcv >= 0 && tcv < e)
      atomicAdd(reinterpret_cast<u64*>(cvg2 + tcv),
                (u64)gather_or(cvg, e, tmn[r], 0));
    if (mn[r] >= 0 && mn[r] < e) {
      remap[mn[r]] = cv;  // -1: no cover
      owner[mn[r]] = (int)i;
    }
  }
  // the twins' remap after the nodes', as the plain version writes them
  for (int r = 0; r < m; ++r) {
    const long long tcv = gather_or(twin, e, cover[r], -1);
    if (tmn[r] >= 0 && tmn[r] < e) {
      remap[tmn[r]] = tcv;
      owner[tmn[r]] = (int)i;
    }
  }
}

__global__ void arcs_kernel(Claims cl, const unsigned char* __restrict__ ok,
                            const long long* __restrict__ from_ed,
                            const long long* __restrict__ to_ed,
                            const long long* __restrict__ mult,
                            const long long* __restrict__ from_node,
                            const long long* __restrict__ to_node,
                            const long long* __restrict__ remap,
                            const int* __restrict__ owner,
                            long long* __restrict__ claim,
                            long long* __restrict__ cvg2,
                            long long* __restrict__ new_f,
                            long long* __restrict__ new_t,
                            long long* __restrict__ new_mult,
                            u64* __restrict__ dropped,
                            const int* __restrict__ gate, long long c,
                            long long e, long long a) {
  if (closed(gate)) return;
  long long n = e > c ? e : c;
  n = n > a ? n : a;
  const long long stride = (long long)gridDim.x * blockDim.x;
  unsigned mine = 0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (i < e) {
      const long long v = cvg2[i];
      cvg2[i] = v < 0 ? 0 : (v > MAX_EDGE_COV ? MAX_EDGE_COV : v);
    }
    if (i < a) {
      const long long f = from_ed[i], t = to_ed[i];
      long long nf = f >= 0 ? gather_or(remap, e, f, -1) : -1;
      long long nt = t >= 0 ? gather_or(remap, e, t, -1) : -1;
      const bool mf = f >= 0 && nf != f;  // from a minority node
      const bool mt = t >= 0 && nt != t;  // to one
      bool drop = nf == nt && f != t;  // a self-loop the merge made
      if (!drop && (mf || mt))  // the bubble's own arcs, no cover, no join
        drop = (mf && f < e && cl.holds(owner[f], t)) ||
               (mt && t < e && cl.holds(owner[t], f)) ||
               gather_or(to_node, e, nf, -1) !=
                   gather_or(from_node, e, nt, -2);
      if (drop) nf = nt = -1;
      mine += f >= 0 && nf < 0;
      new_f[i] = nf;
      new_t[i] = nt;
      new_mult[i] = nf >= 0 ? mult[i] : 0;
    }
    if (i < c && ok[i]) {  // leave the scratch empty for the next wave
      for (int k = 0; k < cl.count(); ++k) {
        const long long x = cl.at(i, k);
        if (x >= 0 && x < e) claim[x] = EMPTY;
      }
    }
  }
  mine = __reduce_add_sync(FULL, mine);
  if ((threadIdx.x & 31) == 0 && mine) atomicAdd(dropped, (u64)mine);
}

unsigned blocks(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

// Blocks of a grid-stride pass over n items: at least 1, at most GRID_CAP.
unsigned grid_for(long long n) {
  const long long b = (n + THREADS - 1) / THREADS;
  return (unsigned)(b < 1 ? 1 : (b > GRID_CAP ? GRID_CAP : b));
}

// Shared memory of a chains_kernel block for m node slots a path.
size_t chains_smem(long long m) {
  return (size_t)(6 * m + 7) * CHAIN_ROWS * sizeof(long long);
}

// Steps 5-6 on `st`: claim_kernel, apply_kernel, arcs_kernel (each returns
// at once when `gate` is 0).
cudaError_t claims_apply_arcs(const Claims& cl, const void* ok,
                              const void* len_a, const void* len_b,
                              const void* cvg, const void* length,
                              const void* twin, const void* deleted,
                              const void* from_ed, const void* to_ed,
                              const void* mult, const void* from_node,
                              const void* to_node, void* claim, void* remap,
                              void* owner, void* cvg2, void* deleted2,
                              void* new_f, void* new_t, void* new_mult,
                              void* n_merged, void* dropped, const int* gate,
                              long long c, long long e, long long a,
                              cudaStream_t st) {
  const auto* okp = static_cast<const unsigned char*>(ok);
  auto* claimp = static_cast<long long*>(claim);
  auto* remapp = static_cast<long long*>(remap);
  auto* ownerp = static_cast<int*>(owner);
  auto* cvg2p = static_cast<long long*>(cvg2);
  auto* del2p = static_cast<unsigned char*>(deleted2);
  auto* mergedp = static_cast<u64*>(n_merged);
  const long long n1 = e > c ? e : c;
  claim_kernel<<<grid_for(n1), THREADS, 0, st>>>(
      cl, okp, static_cast<const long long*>(cvg),
      static_cast<const unsigned char*>(deleted), claimp, cvg2p, del2p,
      remapp, gate, c, e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (c > 0) {
    apply_kernel<<<blocks(c, APPLY_ROWS), APPLY_ROWS, 0, st>>>(
        cl, okp, static_cast<const long long*>(len_a),
        static_cast<const long long*>(len_b),
        static_cast<const long long*>(cvg),
        static_cast<const long long*>(length),
        static_cast<const long long*>(twin), claimp, cvg2p, del2p, remapp,
        ownerp, mergedp, gate, c, e);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long n3 = n1 > a ? n1 : a;
  if (n3 > 0) {
    arcs_kernel<<<grid_for(n3), THREADS, 0, st>>>(
        cl, okp, static_cast<const long long*>(from_ed),
        static_cast<const long long*>(to_ed),
        static_cast<const long long*>(mult),
        static_cast<const long long*>(from_node),
        static_cast<const long long*>(to_node), remapp, ownerp, claimp, cvg2p,
        static_cast<long long*>(new_f), static_cast<long long*>(new_t),
        static_cast<long long*>(new_mult), static_cast<u64*>(dropped), gate,
        c, e, a);
    err = cudaGetLastError();
  }
  return err;
}

Claims claims_of(const void* maj, const void* mnr, const void* tw_maj,
                 const void* tw_mnr, const void* ends, long long m) {
  return Claims{static_cast<const long long*>(maj),
                static_cast<const long long*>(tw_maj),
                static_cast<const long long*>(mnr),
                static_cast<const long long*>(tw_mnr),
                static_cast<const long long*>(ends), (int)m};
}

}  // namespace

extern "C" long long wave_max_m() { return MAX_M; }

extern "C" long long wave_empty() { return EMPTY; }

extern "C" long long wave_max_cand() { return MAX_CAND; }

// Bytes of the front's work buffer for a arc rows, e edges and c
// candidate rows.
extern "C" long long front_work_bytes(long long a, long long e, long long c) {
  FrontWork w;
  return (long long)carve(nullptr, a, e, c, &w);
}

// Enqueues the wave's front on `stream`: eight kernels.  deleted (e,) bool,
// cvg and twin (e,) int64 (cvg within int32), from_ed, to_ed, mult (a,)
// int64 (edge ids -1..e-1, below 2^31), failed (a,) bool; n_edges the
// edges in use.  forest is the (>= e) uint64 scratch, every entry 0 on
// entry and again on exit; work a buffer of front_work_bytes(a, e, c)
// bytes.  Written: cid_arc, u, t0 (c,) int64, cmask and found (c,) bool,
// maj, mnr, tw_maj, tw_mnr (c, m) int64, ends (c, 4) int64, n_back and
// n_cand (one int64 each).  c = min(cand_cap, a) <= wave_max_cand(); all
// contiguous on one card; 0 <= m <= wave_max_m().  Returns the first CUDA
// error (0 on success).
extern "C" int front_launch(
    const void* deleted, const void* cvg, const void* twin,
    const void* from_ed, const void* to_ed, const void* mult,
    const void* failed, void* forest, void* work, void* cid_arc, void* cmask,
    void* u, void* t0, void* maj, void* mnr, void* tw_maj, void* tw_mnr,
    void* ends, void* found, void* n_back, void* n_cand, long long n_edges,
    long long e, long long a, long long c, long long m, void* stream) {
  if (c < 0 || e < 0 || a < c || c > MAX_CAND || m < 0 || m > MAX_M)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FrontWork w;
  carve(static_cast<char*>(work), a, e, c, &w);
  const long long n_live = n_edges < e ? n_edges : e;
  const auto* fe = static_cast<const long long*>(from_ed);
  const auto* te = static_cast<const long long*>(to_ed);
  const auto* mu = static_cast<const long long*>(mult);
  const auto* de = static_cast<const unsigned char*>(deleted);
  const auto* cv = static_cast<const long long*>(cvg);
  auto* fo = static_cast<u64*>(forest);
  auto* nc = static_cast<u64*>(n_cand);
  auto* ci = static_cast<long long*>(cid_arc);
  auto* cm = static_cast<unsigned char*>(cmask);
  auto* up = static_cast<long long*>(u);
  auto* tp = static_cast<long long*>(t0);
  front_forest_kernel<<<grid_for(a), THREADS, 0, st>>>(
      fe, te, mu, de, cv, fo, w.hist, nc, static_cast<u64*>(n_back), a,
      n_live);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a == 0) return (int)err;
  front_cand_kernel<<<grid_for(a), THREADS, 0, st>>>(
      fe, te, mu, de, cv, static_cast<const unsigned char*>(failed), fo,
      w.ckey, w.cflag, w.hist, nc, a, n_live);
  front_select_kernel<<<grid_for(e > a ? e : a), THREADS, 0, st>>>(
      1, w.ckey, w.cflag, w.hist, w.sel, nc, fo, w.prev, a, e, c);
  err = cudaGetLastError();
  if (err != cudaSuccess || c == 0) return (int)err;  // the scratch is empty
  front_select_kernel<<<grid_for(a), THREADS, 0, st>>>(
      2, w.ckey, w.cflag, w.hist, w.sel, nc, fo, w.prev, a, e, c);
  const unsigned nt = (unsigned)tiles_of(a);
  front_count_kernel<<<nt, THREADS, 0, st>>>(w.ckey, w.cflag, w.hist, w.sel,
                                             nc, w.tiles, a, c);
  front_scatter_kernel<<<nt, THREADS, 0, st>>>(w.ckey, w.cflag, w.sel,
                                               w.tiles, nc, w.picked, ci, cm,
                                               up, tp, a, c);
  err = cudaGetLastError();
  if (err != cudaSuccess || c == 0) return (int)err;
  front_sort_kernel<<<1, SORT_THREADS, 0, st>>>(w.picked, nc, fe, te, ci, cm,
                                                up, tp, c);
  chains_kernel<<<blocks(c, CHAIN_ROWS), CHAIN_ROWS, chains_smem(m), st>>>(
      w.prev, up, tp, cm, static_cast<const long long*>(twin),
      static_cast<long long*>(maj), static_cast<long long*>(mnr),
      static_cast<long long*>(tw_maj), static_cast<long long*>(tw_mnr),
      w.s_node, static_cast<long long*>(ends),
      static_cast<unsigned char*>(found), static_cast<u64*>(n_back), c, e,
      (int)m);
  return (int)cudaGetLastError();
}

// Enqueues the wave's back on `stream`: head_kernel, then claim_kernel,
// apply_kernel and arcs_kernel behind its gate.  maj, mnr, tw_maj, tw_mnr
// are (c, m) int64, ends (c, 4) int64, ok, compared and cmask (c,) bool,
// len_a, len_b and cid_arc (c,) int64; cvg, length, twin, from_node,
// to_node (e,) int64 and deleted (e,) bool; from_ed, to_ed, mult (a,)
// int64; n_cand and n_back one int64 each; failed (a,) bool, updated in
// place when no row is ok.  claim is the (>= e) int64 scratch, every entry
// EMPTY on entry and again on exit; remap (e,) int64 and owner (e,) int32
// are scratch, gate one int32.  counts (5,) int64 (merged, overflow,
// backtracked, compared, dropped rows) is written; cvg2 (e,) int64,
// deleted2 (e,) bool, new_f, new_t and new_mult (a,) int64 only when a row
// is ok.  All contiguous on one card; 0 <= m <= wave_max_m().  Returns the
// first CUDA error (0 on success).
extern "C" int back_launch(
    const void* maj, const void* mnr, const void* tw_maj, const void* tw_mnr,
    const void* ends, const void* ok, const void* len_a, const void* len_b,
    const void* cvg, const void* length, const void* twin,
    const void* deleted, const void* from_ed, const void* to_ed,
    const void* mult, const void* from_node, const void* to_node,
    const void* compared, const void* cmask, const void* cid_arc,
    const void* n_cand, const void* n_back, void* failed, void* claim,
    void* remap, void* owner, void* cvg2, void* deleted2, void* new_f,
    void* new_t, void* new_mult, void* counts, void* gate, long long c,
    long long m, long long e, long long a, long long cand_cap,
    void* stream) {
  if (c < 0 || e < 0 || a < 0 || m < 0 || m > MAX_M)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  back_head_kernel<<<1, HEAD_THREADS, 0, st>>>(
      static_cast<const unsigned char*>(ok),
      static_cast<const unsigned char*>(compared),
      static_cast<const unsigned char*>(cmask),
      static_cast<const long long*>(cid_arc),
      static_cast<const long long*>(n_cand),
      static_cast<const long long*>(n_back),
      static_cast<unsigned char*>(failed), static_cast<long long*>(counts),
      static_cast<int*>(gate), c, a, cand_cap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)claims_apply_arcs(
      claims_of(maj, mnr, tw_maj, tw_mnr, ends, m), ok, len_a, len_b, cvg,
      length, twin, deleted, from_ed, to_ed, mult, from_node, to_node, claim,
      remap, owner, cvg2, deleted2, new_f, new_t, new_mult, counts,
      static_cast<long long*>(counts) + 4, static_cast<int*>(gate), c, e, a,
      st);
}
