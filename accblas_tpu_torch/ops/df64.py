"""Double-float (df64) arithmetic on torch tensors.

Every value is an unevaluated sum ``hi + lo`` of two float32 tensors, giving
~49 bits of significand. All operations are error-free transforms
(Dekker/Knuth/Møller) built from separate elementwise ``+ - *`` ops, each of
which torch rounds individually — the property the transforms need. The
device-side twins of these helpers live in ``csrc/df64.cuh``.

Counterpart of ``accblas_tpu.ops.df64``; on the CPU the element-wise helpers
are bit-identical to it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .common import pow2_ceil

__all__ = [
    "DF",
    "two_sum",
    "fast_two_sum",
    "two_prod",
    "df_from",
    "df_add",
    "df_sub",
    "df_mul",
    "df_mul_f32",
    "df_neg",
    "df_to_f32",
    "df_to_f64",
    "df_zeros",
    "df_sum",
    "df_tree_sum",
    "cascaded_fold",
    "cascaded_fold_mid",
    "df_fold_rows",
    "df_fold_lanes",
]


def two_sum(a, b):
    """Error-free sum: (s, e) with s = fl(a+b) and s + e == a + b exactly."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a, b):
    """Error-free sum assuming |a| >= |b| (Dekker)."""
    s = a + b
    e = b - (s - a)
    return s, e


def _split_mask(a):
    """Truncation split: hi keeps sign, exponent and the top 11 mantissa
    bits, lo = a - hi (exact, ≤12-bit significand), so every partial product
    of two_prod fits float32 exactly."""
    hi = (a.view(torch.int32) & -4096).view(torch.float32)
    return hi, a - hi


def two_prod(a, b):
    """Error-free product: (p, e) with p = fl(a*b), p + e == a*b exactly.
    Operands broadcast; a python scalar becomes a 0-d float32 tensor."""
    a = torch.as_tensor(a, dtype=torch.float32)
    b = torch.as_tensor(b, dtype=torch.float32)
    p = a * b
    ah, al = _split_mask(a)
    bh, bl = _split_mask(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


class DF(NamedTuple):
    """A double-float value: unevaluated sum hi + lo of two float32 tensors.

    ``+``, ``-`` and ``*`` against DF or float32 operands run the df64
    arithmetic, so code written against accessor ranges works unchanged when
    the arithmetic type is df64.
    """

    hi: torch.Tensor
    lo: torch.Tensor

    @property
    def shape(self):
        return self.hi.shape

    def __add__(self, other):
        return df_add(self, df_from(other))

    __radd__ = __add__

    def __sub__(self, other):
        return df_sub(self, df_from(other))

    def __rsub__(self, other):
        return df_sub(df_from(other), self)

    def __mul__(self, other):
        if isinstance(other, DF):
            return df_mul(self, other)
        return df_mul_f32(self, other)

    __rmul__ = __mul__

    def __neg__(self):
        return df_neg(self)


def df_from(x) -> DF:
    """Promote a float32 tensor (or python scalar) to DF exactly."""
    if isinstance(x, DF):
        return x
    x = torch.as_tensor(x, dtype=torch.float32)
    return DF(x, torch.zeros_like(x))


def df_zeros(shape, device=None) -> DF:
    z = torch.zeros(shape, dtype=torch.float32, device=device)
    return DF(z, z.clone())


def df_add(x: DF, y: DF) -> DF:
    s, e = two_sum(x.hi, y.hi)
    e = e + (x.lo + y.lo)
    hi, lo = fast_two_sum(s, e)
    return DF(hi, lo)


def df_sub(x: DF, y: DF) -> DF:
    return df_add(x, df_neg(y))


def df_neg(x: DF) -> DF:
    return DF(-x.hi, -x.lo)


def df_mul(x: DF, y: DF) -> DF:
    p, e = two_prod(x.hi, y.hi)
    e = e + (x.hi * y.lo + x.lo * y.hi)
    hi, lo = fast_two_sum(p, e)
    return DF(hi, lo)


def df_mul_f32(x: DF, y) -> DF:
    """DF * float32 (cheaper than full df_mul)."""
    p, e = two_prod(x.hi, y)
    e = e + x.lo * y
    hi, lo = fast_two_sum(p, e)
    return DF(hi, lo)


def df_to_f32(x: DF):
    """Round DF to float32 (the accessor cast-on-store to f32 storage)."""
    return x.hi + x.lo


def df_to_f64(x: DF):
    """The pair's value as a float64 tensor (exact: ≤ ~49 significand bits)."""
    return x.hi.double() + x.lo.double()


def cascaded_fold(p, out_rows: int = 8, err=None) -> DF:
    """Error-compensated pairwise fold of a float32 (R, L) tensor to
    DF(out_rows, L): each halving level uses two_sum, and the rounding terms
    are folded in a plain f32 side channel. `err` is an optional initial
    error tensor of p's shape (e.g. two_prod low words). Odd leftover rows
    fold into row 0; the result is zero-padded up to `out_rows` rows."""
    s = p
    if err is None:
        err = torch.zeros_like(s)
    while s.shape[0] > out_rows:
        half = s.shape[0] // 2
        s_new, e = two_sum(s[:half], s[half : 2 * half])
        err_new = err[:half] + err[half : 2 * half] + e
        if s.shape[0] % 2:
            s0, e0 = two_sum(s_new[:1], s[2 * half :])
            e_row0 = err_new[:1] + e0 + err[2 * half :]
            s_new = torch.cat([s0, s_new[1:]], 0)
            err_new = torch.cat([e_row0, err_new[1:]], 0)
        s, err = s_new, err_new
    if s.shape[0] < out_rows:
        z = s.new_zeros((out_rows - s.shape[0],) + tuple(s.shape[1:]))
        s = torch.cat([s, z], 0)
        err = torch.cat([err, z], 0)
    return DF(s, err)


def cascaded_fold_mid(p, err=None) -> DF:
    """Error-compensated fold of (M, K, L) float32 over the middle axis →
    DF(M, L). K must be a power of two."""
    s = p
    k = s.shape[1]
    if k <= 0 or k & (k - 1):
        raise ValueError(f"middle axis must be a power of two, got {k}")
    while s.shape[1] > 1:
        half = s.shape[1] // 2
        s, e = two_sum(s[:, :half], s[:, half:])
        err = e if err is None else err[:, :half] + err[:, half:] + e
    if err is None:
        err = torch.zeros_like(s)
    return DF(s[:, 0], err[:, 0])


def _check_pow2_fold(total: int, out: int):
    if not (0 < out <= total and total & (total - 1) == 0 and out & (out - 1) == 0):
        raise ValueError(f"pairwise fold needs powers of two, got {total} -> {out}")


def df_fold_rows(x: DF, out_rows: int = 1) -> DF:
    """Pairwise df_add fold of DF (R, L) rows down to (out_rows, L)."""
    _check_pow2_fold(x.hi.shape[0], out_rows)
    cur = x
    while cur.hi.shape[0] > out_rows:
        half = cur.hi.shape[0] // 2
        cur = df_add(DF(cur.hi[:half], cur.lo[:half]), DF(cur.hi[half:], cur.lo[half:]))
    return cur


def df_fold_lanes(x: DF, out_lanes: int = 1) -> DF:
    """Pairwise df_add fold along the last (lane) axis."""
    _check_pow2_fold(x.hi.shape[-1], out_lanes)
    cur = x
    while cur.hi.shape[-1] > out_lanes:
        half = cur.hi.shape[-1] // 2
        cur = df_add(
            DF(cur.hi[..., :half], cur.lo[..., :half]),
            DF(cur.hi[..., half:], cur.lo[..., half:]),
        )
    return cur


def df_tree_sum(p, err=None) -> DF:
    """Exact-compensated pairwise sum of float32 `p` over its last axis,
    zero-padded to a power of two: two_sum at every level, the rounding terms
    (and the optional initial error words `err`, e.g. two_prod low words)
    summed in a plain f32 side channel. The 1-row form of cascaded_fold."""
    n = p.shape[-1]
    w = pow2_ceil(max(n, 1))
    if w != n:
        pad = p.new_zeros(tuple(p.shape[:-1]) + (w - n,))
        p = torch.cat([p, pad], -1)
        err = None if err is None else torch.cat([err, pad], -1)
    while p.shape[-1] > 1:
        h = p.shape[-1] // 2
        p, e = two_sum(p[..., :h], p[..., h:])
        err = e if err is None else err[..., :h] + err[..., h:] + e
    if err is None:
        err = torch.zeros_like(p)
    return DF(p[..., 0], err[..., 0])


def df_sum(x: DF, axis=None) -> DF:
    """Compensated pairwise reduction of a DF tensor with df_add, so every
    partial stays a double-float. axis=None reduces to a scalar DF; an int
    axis reduces that axis. Odd leftovers carry to the next level."""
    if axis is None:
        hi, lo = x.hi.reshape(-1), x.lo.reshape(-1)
    else:
        hi, lo = torch.movedim(x.hi, axis, 0), torch.movedim(x.lo, axis, 0)
    n = hi.shape[0]
    while n > 1:
        half = n // 2
        f = df_add(DF(hi[:half], lo[:half]), DF(hi[half : 2 * half], lo[half : 2 * half]))
        if n % 2:
            hi = torch.cat([f.hi, hi[2 * half :]], 0)
            lo = torch.cat([f.lo, lo[2 * half :]], 0)
            n = half + 1
        else:
            hi, lo = f.hi, f.lo
            n = half
    return DF(hi[0], lo[0])
