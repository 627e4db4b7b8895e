// The Tour-Bus wave's candidate body for Hopper: the chain walk before the
// identity check (chains_launch) and the claim arbitration and apply after
// it (claim_apply_launch).
//
// chains_launch replaces steps 3-4 of the jitted JAX _wave up to the
// identity check, soapdenovo_trans_tpu/graph/tourbus.py:174-219 (the
// backward walks, the first meeting point, the path interiors, their
// twins and the clash test), which XLA fuses into the wave program and the
// port ran as ~147 small launches.  For each candidate row c, with the
// forest prev (E,), the arc u -> t0 and cmask[c]:
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
// claim_apply_launch replaces steps 5-6 of the JAX _wave, tourbus.py:232-325
// (~179 launches in the port): each candidate that passed the identity
// check (ok) claims every node of its two paths, their twins and its ends;
// a candidate wins iff it holds the least (rank, candidate) of every edge
// it claims, rank the minority path's coverage; each winner deletes its
// minority nodes and their twins, adds their coverage onto the majority
// node that covers each one's midpoint (the last majority node if none
// does) and on that node's twin, and remaps them onto it; every arc row is
// remapped, the self-loops this creates dropped (a row whose original from
// and to were equal is kept), cvg2 clamped into [0, MAX_EDGE_COV].
//
// Bound on this card: the bytes.  chains moves u, t0 and cmask (17·C B),
// the prev and twin entries each row's walks and paths read (8 B each) and
// the outputs (32·C·m + 41·C + 8 B): at the main path's C = 1,024, m = 3
// about 0.2 MB, 0.06 us at 3.35 TB/s.  claim_apply must read cvg and
// deleted (9·E B) and the arc rows (24·A) and write cvg2, deleted2 (9·E)
// and the new rows (24·A), plus the ok rows of the candidate arrays: about
// 18·E + 48·A B, tens of MB at the sizes of a real graph, a few us.  On the
// main path both sit at a wave's size, where the launch (a few us each;
// chains a memset and one kernel, claim_apply three kernels that depend on
// each other) and each thread's chain of dependent loads set the time.
//
// Design.  chains: one thread a candidate, 32 candidates a block (one
// warp), each thread's chains, path sides and twins in shared memory
// ([slot][thread], (6m + 7)·8 B a thread: 47,872 B a block at m = 30, so no
// attribute is needed); n_backtracked is one ballot and one atomicAdd a
// block into a counter the launch zeroes with cudaMemsetAsync.
// claim_apply, three kernels on the same stream:
//   claim_kernel, one thread an edge and one a candidate: cvg2 = cvg,
//     deleted2 = deleted, remap = identity (grid-wide: never one block
//     sweeping an array); each ok candidate atomicMin-s its key
//     rank·2^32 + c into the claim scratch at each claimed edge (claims of
//     -1 are skipped, not sent to one spare slot); n_merged = 0.
//   apply_kernel, one thread a candidate: it wins iff the scratch holds its
//     key at every edge it claimed; a winner counts itself into n_merged,
//     deletes its minority nodes and their twins, computes each one's
//     cover, atomicAdd-s the int64 coverage (exact whatever the order) and
//     writes the remap (its claims are disjoint from every other winner's,
//     so no other thread writes these entries).
//   arcs_kernel, one thread an edge, an arc row and a candidate: the clamp
//     of cvg2, the remap of every arc row, and each ok candidate resets the
//     scratch entries it claimed to EMPTY, so the scratch is empty again
//     between waves (the wrapper allocates it once, outside any capture).
// The packed key keeps the order of (rank, c) while |rank| < 2^31: the
// ranks of an EdgeGraph are sums of at most 30 coverages of at most
// MAX_EDGE_COV = 16,000, which the clamp of every wave keeps.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_M = 30;          // node slots a path (-M 3: MAXNODELENGTH)
constexpr int CHAIN_ROWS = 32;     // candidates a block of chains_kernel
constexpr int APPLY_ROWS = 32;     // candidates a block of apply_kernel
constexpr int THREADS = 256;       // threads a block of the grid-wide passes
constexpr long long EMPTY = LLONG_MAX;  // an unclaimed scratch entry
constexpr long long MAX_EDGE_COV = 16000;
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
    long long x = t0[row];
    CA(0) = x;
    for (int k = 1; k < la; ++k) CA(k) = x = gather_or(prev, e, x, -1);
    x = u[row];
    CB(0) = x;
    for (int k = 1; k < lb; ++k) CB(k) = x = gather_or(prev, e, x, -1);

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
  const unsigned votes = __ballot_sync(0xFFFFFFFFu, hit);
  if (tid == 0 && votes) atomicAdd(n_back, (u64)__popc(votes));
}

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

__global__ void claim_kernel(Claims cl, const unsigned char* __restrict__ ok,
                             const long long* __restrict__ cvg,
                             const unsigned char* __restrict__ deleted,
                             long long* __restrict__ claim,
                             long long* __restrict__ cvg2,
                             unsigned char* __restrict__ deleted2,
                             long long* __restrict__ remap,
                             u64* __restrict__ n_merged, long long c,
                             long long e) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < e) {
    cvg2[i] = cvg[i];
    deleted2[i] = deleted[i];
    remap[i] = i;
  }
  if (i == 0) *n_merged = 0;
  if (i < c && ok[i]) {
    const long long key = claim_key(cl, cvg, e, i);
    for (int k = 0; k < cl.count(); ++k) {
      const long long x = cl.at(i, k);
      if (x >= 0 && x < e) atomicMin(claim + x, key);
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
                             u64* __restrict__ n_merged, long long c,
                             long long e) {
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
    if (mn[r] >= 0 && mn[r] < e) remap[mn[r]] = cv > 0 ? cv : 0;
  }
  // the twins' remap after the nodes', as the plain version writes them
  for (int r = 0; r < m; ++r) {
    const long long tcv = gather_or(twin, e, cover[r], -1);
    if (tmn[r] >= 0 && tmn[r] < e) remap[tmn[r]] = tcv > 0 ? tcv : 0;
  }
}

__global__ void arcs_kernel(Claims cl, const unsigned char* __restrict__ ok,
                            const long long* __restrict__ from_ed,
                            const long long* __restrict__ to_ed,
                            const long long* __restrict__ mult,
                            const long long* __restrict__ remap,
                            long long* __restrict__ claim,
                            long long* __restrict__ cvg2,
                            long long* __restrict__ new_f,
                            long long* __restrict__ new_t,
                            long long* __restrict__ new_mult, long long c,
                            long long e, long long a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < e) {
    const long long v = cvg2[i];
    cvg2[i] = v < 0 ? 0 : (v > MAX_EDGE_COV ? MAX_EDGE_COV : v);
  }
  if (i < a) {
    const long long f = from_ed[i], t = to_ed[i];
    long long nf = f >= 0 ? gather_or(remap, e, f, -1) : -1;
    long long nt = t >= 0 ? gather_or(remap, e, t, -1) : -1;
    if (nf == nt && f != t) nf = nt = -1;  // a self-loop the merge made
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

unsigned blocks(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

// Shared memory of a chains_kernel block for m node slots a path.
size_t chains_smem(long long m) {
  return (size_t)(6 * m + 7) * CHAIN_ROWS * sizeof(long long);
}

}  // namespace

extern "C" long long wave_max_m() { return MAX_M; }

extern "C" long long wave_empty() { return EMPTY; }

// Enqueues steps 3-4 of the wave for c candidate rows on `stream`: a
// memset of n_back and one kernel.  prev and twin are (e,) int64, u and t0
// (c,) int64, cmask (c,) bool; maj, mnr, tw_maj, tw_mnr (c, m) int64,
// s_node (c,) int64, ends (c, 4) int64 and found (c,) bool are written, and
// n_back (one int64) the count of rows with a meeting point.  All
// contiguous on one card; 0 <= m <= wave_max_m().  Returns the CUDA error
// (0 on success).
extern "C" int chains_launch(const void* prev, const void* u, const void* t0,
                             const void* cmask, const void* twin, void* maj,
                             void* mnr, void* tw_maj, void* tw_mnr,
                             void* s_node, void* ends, void* found,
                             void* n_back, long long c, long long e,
                             long long m, void* stream) {
  if (c < 0 || e < 0 || m < 0 || m > MAX_M) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(n_back, 0, sizeof(long long), st);
  if (err != cudaSuccess || c == 0) return (int)err;
  chains_kernel<<<blocks(c, CHAIN_ROWS), CHAIN_ROWS, chains_smem(m),
                  st>>>(
      static_cast<const long long*>(prev), static_cast<const long long*>(u),
      static_cast<const long long*>(t0),
      static_cast<const unsigned char*>(cmask),
      static_cast<const long long*>(twin), static_cast<long long*>(maj),
      static_cast<long long*>(mnr), static_cast<long long*>(tw_maj),
      static_cast<long long*>(tw_mnr), static_cast<long long*>(s_node),
      static_cast<long long*>(ends), static_cast<unsigned char*>(found),
      static_cast<u64*>(n_back), c, e, (int)m);
  return (int)cudaGetLastError();
}

// Enqueues steps 5-6 of the wave on `stream`: three kernels.  maj, mnr,
// tw_maj, tw_mnr are (c, m) int64, ends (c, 4) int64, ok (c,) bool, len_a
// and len_b (c,) int64; cvg, length, twin (e,) int64 and deleted (e,) bool;
// from_ed, to_ed, mult (a,) int64.  claim is the (>= e) int64 scratch, every
// entry EMPTY on entry and again on exit; remap an (e,) int64 buffer.
// cvg2 (e,) int64, deleted2 (e,) bool, new_f, new_t, new_mult (a,) int64
// and n_merged (one int64) are written.  All contiguous on one card; 0 <= m
// <= wave_max_m().  Returns the first CUDA error (0 on success).
extern "C" int claim_apply_launch(
    const void* maj, const void* mnr, const void* tw_maj, const void* tw_mnr,
    const void* ends, const void* ok, const void* len_a, const void* len_b,
    const void* cvg, const void* length, const void* twin,
    const void* deleted, const void* from_ed, const void* to_ed,
    const void* mult, void* claim, void* remap, void* cvg2, void* deleted2,
    void* new_f, void* new_t, void* new_mult, void* n_merged, long long c,
    long long m, long long e, long long a, void* stream) {
  if (c < 0 || e < 0 || a < 0 || m < 0 || m > MAX_M)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Claims cl{static_cast<const long long*>(maj),
                  static_cast<const long long*>(tw_maj),
                  static_cast<const long long*>(mnr),
                  static_cast<const long long*>(tw_mnr),
                  static_cast<const long long*>(ends), (int)m};
  const auto* okp = static_cast<const unsigned char*>(ok);
  auto* claimp = static_cast<long long*>(claim);
  auto* remapp = static_cast<long long*>(remap);
  auto* cvg2p = static_cast<long long*>(cvg2);
  auto* del2p = static_cast<unsigned char*>(deleted2);
  auto* mergedp = static_cast<u64*>(n_merged);
  const long long n1 = e > c ? e : c;
  claim_kernel<<<blocks(n1 > 0 ? n1 : 1, THREADS), THREADS, 0, st>>>(
      cl, okp, static_cast<const long long*>(cvg),
      static_cast<const unsigned char*>(deleted), claimp, cvg2p, del2p,
      remapp, mergedp, c, e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (c > 0) {
    apply_kernel<<<blocks(c, APPLY_ROWS), APPLY_ROWS, 0, st>>>(
        cl, okp, static_cast<const long long*>(len_a),
        static_cast<const long long*>(len_b),
        static_cast<const long long*>(cvg),
        static_cast<const long long*>(length),
        static_cast<const long long*>(twin), claimp, cvg2p, del2p, remapp,
        mergedp, c, e);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const long long n3 = n1 > a ? n1 : a;
  if (n3 > 0) {
    arcs_kernel<<<blocks(n3, THREADS), THREADS, 0, st>>>(
        cl, okp, static_cast<const long long*>(from_ed),
        static_cast<const long long*>(to_ed),
        static_cast<const long long*>(mult), remapp, claimp, cvg2p,
        static_cast<long long*>(new_f), static_cast<long long*>(new_t),
        static_cast<long long*>(new_mult), c, e, a);
    err = cudaGetLastError();
  }
  return (int)err;
}
