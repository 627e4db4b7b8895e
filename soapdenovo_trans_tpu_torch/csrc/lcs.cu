// The Tour-Bus identity check for Hopper: the wave's whole identity check,
// path sequences to verdict, in one launch (identity_launch).
//
// identity_launch replaces the identity-check block of the jitted JAX
// _wave, soapdenovo_trans_tpu/graph/tourbus.py:116-133 (_path_seq, once
// for each path), :221-225 (the length gate), :77-96 (the LCS, a
// 384-step lax.scan) and :230 (the verdict ok), which XLA fuses into the
// wave program.  For each candidate row c, with the node lists maj[c, :]
// and mnr[c, :] (-1 padded, in path order):
//   len_a = sum of length[n] over the nodes n of maj (len_b over mnr);
//   compared = found & |len_a - len_b| <= diff & len_a, len_b <= cap;
//   lcs = the LCS of the two path sequences where compared, else 0;
//   ok = compared & lcs·10 >= 9·max(len_a, len_b).
// A path's sequence is seq_pool[seq_off[n] + k] for k < length[n], node
// by node, the pool index clamped into the pool as the JAX gather clamps
// it; a node id outside 0..E-1 adds nothing (the JAX _gather_or's fill).
// The LCS is the bit-parallel one of Allison and Dix in Hyyro's form: V
// is a ceil(len_b/32)-word mask over b, all ones at first; for each base
// a[i], M holds the bits j < len_b with b[j] == a[i], and
// V = (V + (V & M)) | (V & ~M), the addition carried across the words;
// the LCS is the number of zero bits among V's low len_b bits.
//
// Bound on this card: the bytes it must move are the two node lists
// (16·C·m), found, a length for each listed node and an offset for each
// node of a compared row (8 B each), the compared rows' bases and the
// outputs (26·C), over 3.35 TB/s; the operations are len_a·ceil(len_b/64)
// 64-bit word steps a compared row, each eight 32-bit integer operations,
// over the CUDA cores' 16.75 TOP/s.  On the real waves (about a dozen of
// 1,024 rows compared, paths of about K + 1 bases) that is about 75 KB,
// 0.02 us: the launch and one short dependent chain set the time.  At
// 1,024 x 384 with full paths the 18.9M operations take 1.13 us.
//
// Design, for that: one warp a block, one row a lane, so a wave's few
// compared rows run on as many SMs.  The warp first loads the length and
// pool offset of every node slot of its 32 rows, eight slots a lane with
// their loads side by side, into shared memory; each lane then sums its
// row's lengths, gates it, and a row that is not compared is done.  A
// compared lane copies its two paths' bases from seq_pool (16-byte loads,
// a node of each path at once) into its own rows of shared memory: no
// sequence buffer goes to device memory, and the steps of a read bytes
// from shared memory, so the lanes step in lockstep whatever their node
// boundaries.  The match masks of b are built once a row as a per-symbol
// table (Peq) in the lane's shared memory, a row for each base and an
// all-zero row for the padding byte (a step on it leaves V as it is, so
// the step loop needs no bound check inside its unrolled four steps);
// V's 32-bit words stay in registers.  A step of a loads its base's row
// (16-byte loads) and does an and, an add carried word to word in the
// carry flag (add.cc/addc.cc) and an or a word; no ballot, no shuffle,
// no branch.  The warp runs on as many words as its longest compared b
// needs, rounded up to 1, 2, 3, 4, 6, 8, 12 or 16 (a template each, so V
// stays in registers).  On one warp an SM the step's instructions, not
// memory, set the time of a long row.
// Every EdgeGraph pool holds bases 0-3 (tests/test_torch_identity.py pins
// its writers); a row whose a holds a byte above 3 takes a slow loop that
// builds each mask from b's bytes, so the result is exact for any bytes.
// cap <= 512 keeps V and Peq to 16 words each; with m <= 64 node slots
// a block's shared memory is at most 117,504 B (46,848 B at the wave's
// m = 3 and cap = 384).

#include <cuda_runtime.h>

namespace {

// identity_kernel: one warp a block, one row a lane
constexpr int ROWS = 32;
constexpr int MAX_W32 = 16;  // 32-bit words of V and of each Peq row
constexpr long long MAX_CAP = 32LL * MAX_W32;  // the longest path sequence
constexpr int PEQ_WORDS = MAX_W32;  // a Peq row's stride in words
// a lane's Peq table: rows for 0-3 and the padding byte, then 4 words, so
// the lanes' tables stay 16-byte aligned and start in different banks
constexpr int PEQ_LANE = 5 * PEQ_WORDS + 4;
typedef unsigned int u32;

// A node's bases, pool[off, off + len) with the index clamped into the
// pool, copied to shared memory.
struct Span {
  long long off, len;
  unsigned char* dst;
};

// A span byte by byte, each index clamped into the pool: for the spans
// the windows cannot take (an unaligned pool, an index outside it).
__device__ void copy_clamped(const unsigned char* pool, long long s,
                             Span x) {
  for (long long k = 0; k < x.len; ++k) {
    long long p = x.off + k;
    p = p < 0 ? 0 : (p >= s ? s - 1 : p);
    x.dst[k] = __ldg(pool + p);
  }
}

// One window of up to 128 pool bytes from the aligned offset q into the
// lane's 16-byte aligned scratch: 16-byte loads, all in flight, where the
// chunk lies inside the pool, bytes for its last partial one.
__device__ __forceinline__ void load_window(const unsigned char* pool,
                                            long long s, long long q,
                                            long long q1, uint4* scratch) {
  uint4 c[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const long long at = q + 16 * u;
    c[u] = make_uint4(0, 0, 0, 0);
    if (at < q1 && at + 16 <= s) {
      c[u] = __ldg(reinterpret_cast<const uint4*>(pool + at));
    } else if (at < q1) {
      u32 w4[4] = {0, 0, 0, 0};
#pragma unroll
      for (int i = 0; i < 16; ++i)
        if (at + i < s)
          w4[i >> 2] |= (u32)__ldg(pool + at + i) << (8 * (i & 3));
      c[u] = make_uint4(w4[0], w4[1], w4[2], w4[3]);
    }
  }
#pragma unroll
  for (int u = 0; u < 8; ++u)
    if (q + 16 * u < q1) scratch[u] = c[u];
}

// Both spans copied at once, so their loads are in flight together: a
// window of each into the scratch, then the bytes of the span from it.
__device__ __forceinline__ void copy_spans(const unsigned char* pool,
                                           long long s, Span a, Span b,
                                           uint4* scratch) {
  const bool aligned = ((size_t)pool & 15) == 0;
  const bool a_slow = !aligned || a.off < 0 || a.off + a.len > s;
  const bool b_slow = !aligned || b.off < 0 || b.off + b.len > s;
  if (a.len > 0 && a_slow) copy_clamped(pool, s, a);
  if (b.len > 0 && b_slow) copy_clamped(pool, s, b);
  long long qa = a.off & ~15LL, qb = b.off & ~15LL;
  const long long qa1 = a.len > 0 && !a_slow ? a.off + a.len : qa;
  const long long qb1 = b.len > 0 && !b_slow ? b.off + b.len : qb;
  const unsigned char* wa = reinterpret_cast<const unsigned char*>(scratch);
  const unsigned char* wb = wa + 128;
  while (qa < qa1 || qb < qb1) {
    load_window(pool, s, qa, qa1, scratch);
    load_window(pool, s, qb, qb1, scratch + 8);
    const int a_lo = (int)(max(qa, a.off) - qa);
    const int a_hi = (int)(min(qa + 128, qa1) - qa);
    const int a_at = (int)(qa - a.off);
    for (int k = a_lo; k < a_hi; ++k) a.dst[a_at + k] = wa[k];
    const int b_lo = (int)(max(qb, b.off) - qb);
    const int b_hi = (int)(min(qb + 128, qb1) - qb);
    const int b_at = (int)(qb - b.off);
    for (int k = b_lo; k < b_hi; ++k) b.dst[b_at + k] = wb[k];
    qa += 128;
    qb += 128;
  }
}

// A row of W words of the lane's Peq table in shared memory, with the
// widest loads its alignment allows.
template <int W>
__device__ __forceinline__ void load_row(const u32* row, u32 (&m)[W]) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int k = 0; k < W / 4; ++k) {
      const uint4 q = reinterpret_cast<const uint4*>(row)[k];
      m[4 * k] = q.x, m[4 * k + 1] = q.y, m[4 * k + 2] = q.z,
      m[4 * k + 3] = q.w;
    }
  } else if constexpr (W % 2 == 0) {
#pragma unroll
    for (int k = 0; k < W / 2; ++k) {
      const uint2 q = reinterpret_cast<const uint2*>(row)[k];
      m[2 * k] = q.x, m[2 * k + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int w = 0; w < W; ++w) m[w] = row[w];
  }
}

// The LCS of sa[0, n_a) and sb[0, n_b), both in shared memory, 4-byte
// aligned and padded with the byte 4 to a multiple of 4 (sa) and of 32
// (sb) bytes; n_b <= 32·W, every byte of sa a base 0-3.  The lane's Peq
// table (peq: PEQ_LANE words of shared memory, 16-byte aligned) holds a
// row of W words for each base and an all-zero row for the padding byte,
// whose step leaves V as it is; V stays in registers.
template <int W>
__device__ long long lcs_bases(const unsigned char* sa, int n_a,
                               const unsigned char* sb, int n_b,
                               u32* peq) {
#pragma unroll
  for (int w = 0; w < W; ++w) {  // bit k of row c, word w: b[32w + k] == c
    u32 e0 = 0, e1 = 0, e2 = 0, e3 = 0;
    if (32 * w < n_b) {
#pragma unroll
      for (int k = 0; k < 32; k += 4) {
        const u32 four = *reinterpret_cast<const u32*>(sb + 32 * w + k);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const u32 c = (four >> (8 * j)) & 255u, bit = 1u << (k + j);
          e0 |= c == 0 ? bit : 0u;
          e1 |= c == 1 ? bit : 0u;
          e2 |= c == 2 ? bit : 0u;
          e3 |= c == 3 ? bit : 0u;
        }
      }
    }
    peq[w] = e0, peq[PEQ_WORDS + w] = e1, peq[2 * PEQ_WORDS + w] = e2;
    peq[3 * PEQ_WORDS + w] = e3, peq[4 * PEQ_WORDS + w] = 0;
  }
  u32 v[W];
#pragma unroll
  for (int w = 0; w < W; ++w) v[w] = ~0u;
  for (int i = 0; i < n_a; i += 4) {
    const u32 four = *reinterpret_cast<const u32*>(sa + i);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      u32 m[W], t[W];
      load_row<W>(peq + PEQ_WORDS * ((four >> (8 * j)) & 7u), m);
      // V = (V + (V & M)) | (V & ~M), the add carried word to word in
      // the carry flag
#pragma unroll
      for (int w = 0; w < W; ++w) {
        if (w == 0)
          asm volatile("add.cc.u32 %0, %1, %2;"
                       : "=r"(t[w]) : "r"(v[w]), "r"(v[w] & m[w]));
        else
          asm volatile("addc.cc.u32 %0, %1, %2;"
                       : "=r"(t[w]) : "r"(v[w]), "r"(v[w] & m[w]));
      }
#pragma unroll
      for (int w = 0; w < W; ++w) v[w] = t[w] | (v[w] & ~m[w]);
    }
  }
  long long zeros = 0;
#pragma unroll
  for (int w = 0; w < W; ++w) {
    const int bits = min(32, max(0, n_b - 32 * w));
    zeros += __popc(~v[w] & (bits == 32 ? ~0u : (1u << bits) - 1));
  }
  return zeros;
}

// The same for any bytes (a row whose a holds a byte above 3): each
// step's mask is built from b's bytes.  Exact, and slow; no EdgeGraph
// pool sends a row here.
__device__ long long lcs_bytes(const unsigned char* sa, int n_a,
                               const unsigned char* sb, int n_b) {
  u32 v[MAX_W32];
#pragma unroll
  for (int w = 0; w < MAX_W32; ++w) v[w] = ~0u;
  for (int i = 0; i < n_a; ++i) {
    const u32 c = sa[i];
    u32 carry = 0;
#pragma unroll
    for (int w = 0; w < MAX_W32; ++w) {
      u32 m = 0;
      for (int k = 0; k < 32 && 32 * w + k < n_b; ++k)
        m |= sb[32 * w + k] == c ? 1u << k : 0u;
      const u32 x = v[w], y = x + (x & m), t = y + carry;
      carry = (y < x) | (t < y);
      v[w] = t | (x & ~m);
    }
  }
  long long zeros = 0;
#pragma unroll
  for (int w = 0; w < MAX_W32; ++w) {
    const int bits = min(32, max(0, n_b - 32 * w));
    zeros += __popc(~v[w] & (bits == 32 ? ~0u : (1u << bits) - 1));
  }
  return zeros;
}

// lcs_bases on the fewest words of {1, 2, 3, 4, 6, 8, 12, 16} that hold
// `words`, a count the whole warp shares.
__device__ long long lcs_bases_on(int words, const unsigned char* sa,
                                  int n_a, const unsigned char* sb, int n_b,
                                  u32* peq) {
  if (words <= 1) return lcs_bases<1>(sa, n_a, sb, n_b, peq);
  if (words <= 2) return lcs_bases<2>(sa, n_a, sb, n_b, peq);
  if (words <= 3) return lcs_bases<3>(sa, n_a, sb, n_b, peq);
  if (words <= 4) return lcs_bases<4>(sa, n_a, sb, n_b, peq);
  if (words <= 6) return lcs_bases<6>(sa, n_a, sb, n_b, peq);
  if (words <= 8) return lcs_bases<8>(sa, n_a, sb, n_b, peq);
  if (words <= 12) return lcs_bases<12>(sa, n_a, sb, n_b, peq);
  return lcs_bases<MAX_W32>(sa, n_a, sb, n_b, peq);
}

__global__ void identity_kernel(
    const long long* __restrict__ maj, const long long* __restrict__ mnr,
    const unsigned char* __restrict__ found,
    const long long* __restrict__ length,
    const long long* __restrict__ seq_off,
    const unsigned char* __restrict__ pool, long long* __restrict__ len_a,
    long long* __restrict__ len_b, unsigned char* __restrict__ compared,
    unsigned char* __restrict__ ok, long long* __restrict__ lcs,
    long long rows, int m, long long e, long long s, long long diff,
    long long cap, int stride) {
  extern __shared__ __align__(16) long long smem[];
  const int lane = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * ROWS;
  const int nrows = (int)min((long long)ROWS, rows - r0);
  const int cnt = nrows * m;  // node slots of each path in this block
  long long* s_len = smem;              // [2 · cnt]: a's slots, then b's
  long long* s_off = smem + 2 * ROWS * m;
  uint4* s_scratch = reinterpret_cast<uint4*>(smem + 4 * ROWS * m);
  u32* s_peq = reinterpret_cast<u32*>(s_scratch + 16 * ROWS);
  unsigned char* s_seq = reinterpret_cast<unsigned char*>(
      s_peq + PEQ_LANE * ROWS);         // [2][ROWS][stride]: a's, b's

  const bool is_found = lane < nrows && found[r0 + lane];
  // every slot's length and pool offset, eight slots a lane at a time,
  // their loads side by side
  for (int q0 = lane; q0 < 2 * cnt; q0 += 8 * ROWS) {
    long long n[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int q = q0 + u * ROWS;
      n[u] = q >= 2 * cnt ? -1
             : __ldg(q < cnt ? maj + r0 * m + q : mnr + r0 * m + (q - cnt));
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int q = q0 + u * ROWS;
      const bool live = n[u] >= 0 && n[u] < e;
      const long long ln = live ? __ldg(length + n[u]) : 0;
      const long long of = live ? __ldg(seq_off + n[u]) : 0;
      if (q < 2 * cnt) s_len[q] = ln, s_off[q] = of;
    }
  }
  __syncwarp();

  long long n_a = 0, n_b = 0;
  bool cmp = false;
  if (lane < nrows) {
    for (int k = 0; k < m; ++k) {
      n_a += s_len[lane * m + k];
      n_b += s_len[cnt + lane * m + k];
    }
    const long long gap = n_a > n_b ? n_a - n_b : n_b - n_a;
    cmp = is_found && gap <= diff && n_a <= cap && n_b <= cap;
  }
  // the warp's LCS runs on the longest b it compares
  const int words = __reduce_max_sync(0xFFFFFFFFu,
                                      cmp ? (int)((n_b + 31) >> 5) : 0);
  long long score = 0;
  if (words > 0 && cmp) {
    unsigned char* sa = s_seq + (size_t)lane * stride;
    unsigned char* sb = sa + (size_t)ROWS * stride;
    long long pa = 0, pb = 0;
    for (int k = 0; k < m; ++k) {
      const int qa = lane * m + k, qb = cnt + qa;
      copy_spans(pool, s, Span{s_off[qa], s_len[qa], sa + pa},
                 Span{s_off[qb], s_len[qb], sb + pb}, s_scratch + 16 * lane);
      pa += s_len[qa];
      pb += s_len[qb];
    }
    u32 high = 0;  // any byte of a above 3?
    for (int i = 0; i < n_a; ++i) high |= sa[i];
    if (high & ~3u) {
      score = lcs_bytes(sa, (int)n_a, sb, (int)n_b);
    } else {
      for (int i = (int)n_a; i < ((int)n_a + 3) / 4 * 4; ++i) sa[i] = 4;
      for (int i = (int)n_b; i < ((int)n_b + 31) / 32 * 32; ++i) sb[i] = 4;
      score = lcs_bases_on(words, sa, (int)n_a, sb, (int)n_b,
                           s_peq + PEQ_LANE * lane);
    }
  }
  if (lane < nrows) {
    const long long r = r0 + lane;
    len_a[r] = n_a;
    len_b[r] = n_b;
    compared[r] = cmp;
    lcs[r] = score;
    ok[r] = cmp && score * 10 >= 9 * (n_a > n_b ? n_a : n_b);
  }
}

// Dynamic shared memory of an identity_kernel block for m node slots a
// path and cap bases (a lane's sequence rows: an odd count of 4-byte words
// apart, so the lanes' bytes at one position lie in distinct banks, with
// room for the padding: a to 4 bytes, b to 32).
int identity_stride(long long cap) {
  return 4 * (((((int)cap + 31) / 32 * 32) / 4 + 1) | 1);
}

size_t identity_smem(long long m, long long cap) {
  return 4 * ROWS * m * sizeof(long long) + ROWS * 16 * sizeof(uint4) +
         ROWS * PEQ_LANE * sizeof(u32) +
         (size_t)ROWS * 2 * identity_stride(cap);
}

}  // namespace

extern "C" long long identity_max_cap() { return MAX_CAP; }

// Lets identity_kernel take, on the current device, the most dynamic
// shared memory an identity_launch can ask for (m = 64, cap = MAX_CAP:
// 117,504 B; more than 48 KB needs the attribute).  Call it once a
// device before the first launch there, outside any stream capture: the
// launch itself sets nothing, so it can be captured into a CUDA graph.
// Returns the CUDA error (0 on success).
extern "C" int identity_reserve() {
  return (int)cudaFuncSetAttribute(
      identity_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)identity_smem(64, MAX_CAP));
}

// Enqueues the identity check of `rows` candidate rows on `stream`;
// returns the CUDA error of the launch (0 on success).  maj and mnr are
// (rows, m) int64 node lists, found (rows,) bool, length and seq_off (e,)
// int64, pool (s,) uint8 with s >= 1; len_a, len_b and lcs are (rows,)
// int64 outputs, compared and ok (rows,) bool; all contiguous on one
// card, cap <= MAX_CAP.  A block needing more than 48 KB of shared
// memory (m = 30 at cap = 384) launches only after identity_reserve().
extern "C" int identity_launch(const void* maj, const void* mnr,
                               const void* found, const void* length,
                               const void* seq_off, const void* pool,
                               void* len_a, void* len_b, void* compared,
                               void* ok, void* lcs, long long rows,
                               long long m, long long e, long long s,
                               long long diff, long long cap, void* stream) {
  if (rows <= 0) return 0;
  if (cap < 0 || cap > MAX_CAP || m < 0 || m > 64 || e < 1 || s < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  identity_kernel<<<(unsigned)((rows + ROWS - 1) / ROWS), ROWS,
                    identity_smem(m, cap), st>>>(
      static_cast<const long long*>(maj), static_cast<const long long*>(mnr),
      static_cast<const unsigned char*>(found),
      static_cast<const long long*>(length),
      static_cast<const long long*>(seq_off),
      static_cast<const unsigned char*>(pool),
      static_cast<long long*>(len_a), static_cast<long long*>(len_b),
      static_cast<unsigned char*>(compared), static_cast<unsigned char*>(ok),
      static_cast<long long*>(lcs), rows, (int)m, e, s, diff, cap,
      identity_stride(cap));
  return (int)cudaGetLastError();
}
