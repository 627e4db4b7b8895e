"""Multiword 2-bit-packed k-mer arithmetic on int64-held uint32 lanes.

Port of ``soapdenovo_trans_tpu/ops/bits.py``: a k-mer is a ``(..., W)``
tensor, ``W = ceil(2K / 32)``, word 0 most significant, the k-mer in the
low ``2K`` bits with its first base in the top slot.  Each lane holds a
uint32 value in an int64 (torch has no ``>>`` for uint32 on the CPU), so
every left shift is masked back to 32 bits: JAX's uint32 wraps, int64
does not.

Base encoding matches the reference (src/inc/def.h:39):
A=0, C=1, T=2, G=3, N/absent=4;  complement(b) = b ^ 2.
"""

from __future__ import annotations

import numpy as np
import torch

BASE_CHARS = "ACTG"  # index == base code (reference int2base)
BASE_N = 4  # 'N' / invalid / absent marker
LANE_MASK = 0xFFFFFFFF

# Lookup table: ASCII byte -> base code (anything unknown -> 4).
_CHAR2CODE = np.full(256, BASE_N, dtype=np.uint8)
for _i, _c in enumerate(BASE_CHARS):
    _CHAR2CODE[ord(_c)] = _i
    _CHAR2CODE[ord(_c.lower())] = _i


def words_for_k(k: int) -> int:
    """Number of 32-bit lanes needed for a K-mer (2 bits/base)."""
    return (2 * k + 31) // 32


def mask_list(k: int) -> list:
    """Per-lane masks selecting the low 2K bits of the multiword int."""
    w = words_for_k(k)
    out = []
    for i in range(w):
        used = min(32, max(0, 2 * k - 32 * (w - 1 - i)))
        out.append((1 << used) - 1)
    return out


def _mask(k: int, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(mask_list(k), dtype=torch.int64, device=like.device)


def _shl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Lane-wise uint32 left shift (wraps like JAX's uint32)."""
    return (x << s) & LANE_MASK


def _carry_up(carry: torch.Tensor) -> torch.Tensor:
    """carry[..., i] moves to lane i-1 (towards the most significant)."""
    return torch.cat([carry[..., 1:], torch.zeros_like(carry[..., :1])], -1)


def _carry_down(carry: torch.Tensor) -> torch.Tensor:
    """carry[..., i] moves to lane i+1 (towards the least significant)."""
    return torch.cat([torch.zeros_like(carry[..., :1]), carry[..., :-1]], -1)


def _shl2(km: torch.Tensor) -> torch.Tensor:
    """Shift the multiword value left by 2 bits (overflow dropped)."""
    return _shl(km, 2) | _carry_up(km >> 30)


def _shr2(km: torch.Tensor) -> torch.Tensor:
    """Shift the multiword value right by 2 bits."""
    return (km >> 2) | _carry_down(_shl(km & 3, 30))


def next_kmer(km: torch.Tensor, base, k: int) -> torch.Tensor:
    """Append ``base`` on the right, dropping the leftmost base
    (reference nextKmer, src/kmer.c:209).  An N code (4) is masked to
    its low 2 bits, as in the JAX package."""
    b = torch.as_tensor(base, dtype=torch.int64, device=km.device) & 3
    out = _shl2(km)
    out[..., -1] |= b
    return out & _mask(k, km)


def prev_kmer(km: torch.Tensor, base, k: int) -> torch.Tensor:
    """Prepend ``base`` on the left, dropping the rightmost base
    (reference prevKmer, src/kmer.c:230)."""
    w = words_for_k(k)
    p = 2 * k - 2
    b = torch.as_tensor(base, dtype=torch.int64, device=km.device) & 3
    out = _shr2(km)
    out[..., w - 1 - p // 32] |= b << (p % 32)
    return out


def _reverse_pairs_in_word(x: torch.Tensor) -> torch.Tensor:
    """Reverse the order of the 16 2-bit groups inside each lane."""
    x = (x >> 16) | _shl(x, 16)
    x = ((x >> 8) & 0x00FF00FF) | ((x & 0x00FF00FF) << 8)
    x = ((x >> 4) & 0x0F0F0F0F) | ((x & 0x0F0F0F0F) << 4)
    x = ((x >> 2) & 0x33333333) | ((x & 0x33333333) << 2)
    return x


def shr_const(km: torch.Tensor, s: int) -> torch.Tensor:
    """Shift the multiword value right by a static 0 <= s < 32 bits."""
    if s == 0:
        return km
    return (km >> s) | _carry_down(_shl(km, 32 - s))


def widen(km: torch.Tensor, w_out: int) -> torch.Tensor:
    """Prepend zero lanes so the value occupies w_out lanes."""
    w_in = km.shape[-1]
    if w_out == w_in:
        return km
    if w_out < w_in:
        raise ValueError(f"cannot widen {w_in} lanes to {w_out}")
    pad = km.new_zeros(km.shape[:-1] + (w_out - w_in,))
    return torch.cat([pad, km], -1)


def shl_const(km: torch.Tensor, s: int) -> torch.Tensor:
    """Shift the multiword value left by a static 0 <= s < 32 bits
    (overflow beyond word 0 is dropped — widen() first if needed)."""
    if s == 0:
        return km
    return _shl(km, s) | _carry_up(km >> (32 - s))


def reverse_complement(km: torch.Tensor, k: int) -> torch.Tensor:
    """Branchless reverse complement (reference fastReverseComp,
    src/kmer.c:548-646): complement by XOR, reverse the 2-bit groups and
    the lane order, realign to the low 2K bits."""
    w = words_for_k(k)
    rev = _reverse_pairs_in_word(km ^ 0xAAAAAAAA).flip(-1)
    return shr_const(rev, 32 * w - 2 * k) & _mask(k, km)


_BIAS = 1 << 31


def fold2(lanes: torch.Tensor) -> torch.Tensor:
    """(..., 2) lanes -> (...) int64 keys in the same order: the 64-bit
    unsigned value with its top bit flipped, read as signed.  The
    all-ones sentinel row becomes int64 max and still sorts last."""
    return (lanes[..., 0] - _BIAS) * (1 << 32) + lanes[..., 1]


def unfold2(key: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`fold2`."""
    return torch.stack([(key >> 32) + _BIAS, key & LANE_MASK], -1)


def sort_keys(lanes: torch.Tensor) -> list:
    """Order-preserving int64 sort keys of (N, W) lanes, most
    significant first: lanes folded pairwise from the low end."""
    w = lanes.shape[-1]
    keys = []
    hi = w
    while hi > 0:
        if hi >= 2:
            keys.append(fold2(lanes[..., hi - 2:hi]))
            hi -= 2
        else:
            keys.append(lanes[..., 0])
            hi -= 1
    return keys[::-1]


def lex_order(lanes: torch.Tensor) -> torch.Tensor:
    """Permutation that sorts (N, W) rows ascending (torch has no
    multi-key sort): stable sorts key by key, least significant first.
    Equal rows keep their input order."""
    order = None
    for key in reversed(sort_keys(lanes)):
        cur = key if order is None else key[order]
        idx = torch.sort(cur, stable=True).indices
        order = idx if order is None else order[idx]
    return order


def lex_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b as multiword unsigned integers (reference KmerSmaller)."""
    w = a.shape[-1]
    res = a[..., w - 1] < b[..., w - 1]
    for i in range(w - 2, -1, -1):
        res = (a[..., i] < b[..., i]) | ((a[..., i] == b[..., i]) & res)
    return res


def lex_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a == b (reference KmerEqual)."""
    return (a == b).all(-1)


def canonical(km: torch.Tensor, k: int):
    """min(kmer, revcomp) plus a flag saying the revcomp was chosen
    (reference chopKmer4read, src/prlHashReads.c:215-230)."""
    return canonical_pair(km, reverse_complement(km, k))


def canonical_pair(km: torch.Tensor, rc: torch.Tensor):
    """Like :func:`canonical` with the revcomp already computed."""
    use_rc = lex_less(rc, km)
    return torch.where(use_rc[..., None], rc, km), use_rc


def last_base(km: torch.Tensor) -> torch.Tensor:
    """Code of the k-mer's last (rightmost) base."""
    return (km[..., -1] & 3).to(torch.uint8)


def first_base(km: torch.Tensor, k: int) -> torch.Tensor:
    """Code of the k-mer's first (leftmost) base."""
    p = 2 * k - 2
    word = km[..., words_for_k(k) - 1 - p // 32]
    return ((word >> (p % 32)) & 3).to(torch.uint8)


def get_base(km: torch.Tensor, pos, k: int) -> torch.Tensor:
    """Base code at position ``pos`` (0 = leftmost/first base)."""
    w = words_for_k(k)
    p = 2 * (k - 1) - 2 * torch.as_tensor(pos, dtype=torch.int64,
                                          device=km.device)
    p = p.expand(km.shape[:-1])
    word = torch.gather(km, -1, ((w - 1) - p // 32)[..., None])[..., 0]
    return ((word >> (p % 32)) & 3).to(torch.uint8)


def append_base(km: torch.Tensor, base, k: int) -> torch.Tensor:
    """Extend a K-mer to a (K+1)-mer by appending a base on the right
    (reference KmerPlus); the output has words_for_k(k + 1) lanes."""
    out = _shl2(widen(km, words_for_k(k + 1)))
    out[..., -1] |= torch.as_tensor(base, dtype=torch.int64,
                                    device=km.device)
    return out & _mask(k + 1, km)


# ---------------------------------------------------------------------------
# Host-side (numpy) helpers, for IO and tests.
# ---------------------------------------------------------------------------

def encode_seq(s: str) -> np.ndarray:
    """ASCII string -> (len,) uint8 base codes (N and unknown -> 4)."""
    return _CHAR2CODE[np.frombuffer(s.encode("ascii"), dtype=np.uint8)]


def decode_seq(codes) -> str:
    """(len,) base codes -> ASCII string (4 -> 'N')."""
    lut = np.frombuffer(b"ACTGN", dtype=np.uint8)
    return bytes(lut[np.asarray(codes, dtype=np.uint8)]).decode("ascii")


def kmer_from_string(s: str) -> np.ndarray:
    """String of length K -> (W,) int64 lanes (host side); N and unknown
    characters enter as code 4, as in the JAX package."""
    w = words_for_k(len(s))
    val = 0
    for ch in s:
        val = (val << 2) | int(_CHAR2CODE[ord(ch)])
    return np.array([(val >> (32 * (w - 1 - i))) & LANE_MASK
                     for i in range(w)], dtype=np.int64)


_COMPLEMENT = str.maketrans("ACGTN", "TGCAN")


def revcomp_str(s: str) -> str:
    """Host-side reverse complement over ACGT/N strings."""
    return s.upper().translate(_COMPLEMENT)[::-1]


def kmer_to_string(km, k: int) -> str:
    """(W,) lanes -> string of length K (host side)."""
    val = 0
    for x in np.asarray(km).tolist():
        val = (val << 32) | int(x)
    return "".join(BASE_CHARS[(val >> (2 * (k - 1 - i))) & 3]
                   for i in range(k))
