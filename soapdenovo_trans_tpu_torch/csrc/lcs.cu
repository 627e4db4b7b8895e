// Longest common subsequence of a batch of byte-string pairs, for Hopper.
//
// Replaces the JAX Tour-Bus identity check soapdenovo_trans_tpu/graph/
// tourbus.py:77-96 (_lcs_scores, a 384-step lax.scan inside the jitted
// _wave; an XLA device loop, not a Pallas kernel).  For each row r it
// writes the length of the LCS of a[r, :min(la[r], cap)] and
// b[r, :min(lb[r], cap)]; a length <= 0 is an empty string.
//
// Design: the bit-parallel LCS of Allison and Dix in Hyyro's form, one warp
// a pair.  V is a ceil(lb/64)-word mask over b, all ones at first; for
// each a[i], M holds the bits j < lb with b[j] == a[i], and
// V = (V + (V & M)) | (V & ~M), the addition carried across the words.
// The LCS is the number of zero bits among V's low lb bits.  Each lane
// keeps two bytes of b a word in registers, so two __ballot_sync calls
// build a 64-bit word of M for any byte value; every lane then runs the
// same carry chain on the same words (the ballots are warp-uniform), and
// the bytes of a reach all lanes by __shfl_sync, 32 at a time.  A pair
// costs min(la, cap) steps of ceil(min(lb, cap)/64) words: the work
// follows the path lengths, not cap.
//
// Bound on this card, from a call's lengths (n_a = min(la, cap), n_b =
// min(lb, cap)): the bytes 24·P + sum(n_a) + sum(n_b) (the two prefixes
// read, la, lb and out one int64 each) over 3.35 TB/s, against the
// sum(n_a·ceil(n_b/64)) word steps, each eight 32-bit integer operations
// (and, add, and-not, or on 64 bits), over the CUDA cores' 16.75 TOP/s.
// At 1,024 x 384 with la = lb = 384 the operations are the larger: 18.9M
// of them take 1.13 us, the 811,008 B 0.24 us.  On the Tour-Bus waves
// (about a dozen rows compared, paths of about K + 1 bases) the bytes
// are the larger: about 25 KB, 0.008 us.  At these sizes the kernel is bound by its
// launch and by the la-step dependency chain of each warp, not by either.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;                  // pairs per block
constexpr int MAX_WORDS = 8;              // 64-bit words of V: cap <= 512
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ long long clamp_len(long long n, long long cap) {
  return n < 0 ? 0 : (n > cap ? cap : n);
}

__global__ void lcs_kernel(const unsigned char* __restrict__ a,
                           const unsigned char* __restrict__ b,
                           const long long* __restrict__ la,
                           const long long* __restrict__ lb,
                           long long* __restrict__ out, long long p,
                           long long cap) {
  const int lane = threadIdx.x & 31;
  const long long r =
      (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (r >= p) return;  // the whole warp leaves together
  const int n_a = (int)clamp_len(la[r], cap);
  const int n_b = (int)clamp_len(lb[r], cap);
  const int words = (n_b + 63) >> 6;
  const unsigned char* ar = a + r * cap;
  const unsigned char* br = b + r * cap;

  // b[64w + lane] and b[64w + 32 + lane]; -1 past n_b matches no byte
  int b_lo[MAX_WORDS], b_hi[MAX_WORDS];
  unsigned long long v[MAX_WORDS];
#pragma unroll
  for (int w = 0; w < MAX_WORDS; ++w) {
    const int j = 64 * w + lane;
    b_lo[w] = j < n_b ? br[j] : -1;
    b_hi[w] = j + 32 < n_b ? br[j + 32] : -1;
    v[w] = ~0ull;
  }

  for (int base = 0; base < n_a; base += 32) {
    const int mine = base + lane < n_a ? ar[base + lane] : 0;
    const int steps = min(32, n_a - base);
    for (int k = 0; k < steps; ++k) {
      const int ai = __shfl_sync(FULL, mine, k);
      unsigned long long carry = 0;
#pragma unroll
      for (int w = 0; w < MAX_WORDS; ++w) {
        if (w < words) {  // warp-uniform: n_b is the pair's
          const unsigned lo = __ballot_sync(FULL, b_lo[w] == ai);
          const unsigned hi = __ballot_sync(FULL, b_hi[w] == ai);
          const unsigned long long m =
              ((unsigned long long)hi << 32) | lo;
          const unsigned long long x = v[w];
          const unsigned long long s = x + (x & m);
          const unsigned long long t = s + carry;
          carry = (s < x) | (t < s);
          v[w] = t | (x & ~m);
        }
      }
    }
  }

  if (lane == 0) {
    long long zeros = 0;
#pragma unroll
    for (int w = 0; w < MAX_WORDS; ++w) {
      if (w < words) {
        const int bits = min(64, n_b - 64 * w);
        const unsigned long long low =
            bits == 64 ? ~0ull : ((1ull << bits) - 1);
        zeros += __popcll(~v[w] & low);
      }
    }
    out[r] = zeros;
  }
}

}  // namespace

extern "C" long long lcs_max_cap() { return 64LL * MAX_WORDS; }

// Enqueues the LCS of p pairs of rows of length cap on `stream`; returns
// cudaGetLastError() after the launch (0 on success).  a and b are (p, cap)
// uint8, la, lb and out (p,) int64, all contiguous on one card.
extern "C" int lcs_launch(const void* a, const void* b, const void* la,
                          const void* lb, void* out, long long p,
                          long long cap, void* stream) {
  if (p <= 0) return 0;
  if (cap < 0 || cap > lcs_max_cap()) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  lcs_kernel<<<(unsigned)((p + WARPS - 1) / WARPS), 32 * WARPS, 0, s>>>(
      static_cast<const unsigned char*>(a),
      static_cast<const unsigned char*>(b),
      static_cast<const long long*>(la), static_cast<const long long*>(lb),
      static_cast<long long*>(out), p, cap);
  return (int)cudaGetLastError();
}
