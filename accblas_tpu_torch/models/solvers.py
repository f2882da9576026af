"""Mixed-precision iterative solvers: the application tier.

What the accessor buys in a user's loop: Krylov and stationary solvers whose
*storage* is cheap (bf16/f32 operands stream at storage bandwidth through
the GEMV kernel) while the *arithmetic* that controls convergence (the dot
products, the residual) runs wider (f32, or df64 through the DOT kernel).
Counterpart of ``accblas_tpu.models.solvers``, with its signatures and its
results.

The JAX package's ``lax.while_loop`` and ``lax.scan`` become Python loops
that never read a value back to the host: the state stays in device
tensors, and ``cg`` freezes it with ``torch.where`` once it has stopped, as
the JAX loop's exit does. Every matrix-vector product is ``acc_gemv`` and
every dot product ``acc_dot`` (the port's kernels on a CUDA tensor, their
plain versions on a CPU tensor).
"""

from __future__ import annotations

import torch

from ..ops import df64 as dfm
from ..ops import dot as dotops
from ..ops import gemv as gemvops
from ..utils.spans import span

# with tol > 0, cg reads its 0-d `live` flag on the host once per this many
# iterations to stop early; the frozen state does not move, so the results
# do not depend on it
POLL_EVERY = 16


def _matvec(a, x, ar: str):
    """alpha = 1, beta = 0 accessor GEMV returning f32 (beta = 0 never reads
    the result vector passed in)."""
    res = torch.empty(a.shape[0], dtype=torch.float32, device=a.device)
    return gemvops.acc_gemv(a, x.to(a.dtype), res, 1.0, 0.0, ar=ar)


def _dot(x, y, ar: str):
    """The accessor DOT as a 0-d f32 tensor on x's device; df64 takes exact
    products and rounds its (hi, lo) pair to f32 there."""
    out = dotops.acc_dot(x, y, ar=ar, precise=(ar == "df64"))
    if isinstance(out, dfm.DF):
        return dfm.df_to_f32(out)
    return out.float()


def cg(a, b, *, iters: int = 50, ar: str = "f32", tol: float = 0.0, matvec=None, dot=None):
    """Conjugate gradients on an SPD matrix with accessor kernels.

    Storage comes from `a` (bf16/f16/f32); `ar` sets the arithmetic of the
    matvec and of the two dot products per iteration ('f32' or 'df64').
    Returns (x, the final |r|^2, the iterations run), the last two as 0-d
    tensors on the device.

    `matvec(p) -> f32 vector` and `dot(u, v) -> 0-d f32 tensor` may be
    injected to run the same recurrence over other kernels.

    The loop makes `iters` passes and no host read when tol == 0. An
    iteration counts while (it < iters) and (|r|^2 > tol2); once that fails
    every update is masked, so x, |r|^2 and it stay as they were, as when the
    JAX loop exits. With tol > 0 the host reads the flag every POLL_EVERY
    iterations and stops early.

    Guarded updates as in the JAX package: den = p·Ap <= 0 gives alpha = 0,
    and den < 0 (a breakdown: the operator is not SPD) sets |r|^2 to NaN,
    which stops the loop and tells the caller apart from convergence.
    """
    with span("accblas.cg"):
        mv = matvec if matvec is not None else (lambda p: _matvec(a, p, ar))
        dt = dot if dot is not None else (lambda u, v: _dot(u, v, ar))
        b32 = b.float()
        dev = b32.device
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        one = torch.ones((), dtype=torch.float32, device=dev)
        nan = torch.full((), float("nan"), dtype=torch.float32, device=dev)
        x, r, p = torch.zeros_like(b32), b32, b32
        rs = dt(r, r)
        it = torch.zeros((), dtype=torch.int32, device=dev)
        # tol == 0 is a fixed budget with no residual exit at all (an rs > 0
        # guard would stop a converged recurrence whose rs underflows to 0)
        tol2 = -one if tol == 0.0 else torch.tensor(tol, dtype=torch.float32, device=dev) ** 2 \
            * dt(b32, b32)
        live = (it < iters) & (rs > tol2)
        for i in range(iters):
            if tol != 0.0 and i % POLL_EVERY == 0 and i:
                with span("accblas.cg.poll"):
                    done = not bool(live)
                if done:
                    break
            # each pass ends by taking the next pass's flag, so the poll
            # that reads it lies between passes, outside both
            with span("accblas.cg.pass"):
                ap = mv(p)
                den = dt(p, ap)
                pos = den > 0.0
                alpha = torch.where(pos, rs / torch.where(pos, den, one), zero)
                x_new = x + alpha * p
                r_new = r - alpha * ap
                rs_new = torch.where(den < 0.0, nan, dt(r_new, r_new))
                pos = rs > 0.0
                beta = torch.where(pos, rs_new / torch.where(pos, rs, one), zero)
                p_new = r_new + beta * p
                x = torch.where(live, x_new, x)
                r = torch.where(live, r_new, r)
                p = torch.where(live, p_new, p)
                rs = torch.where(live, rs_new, rs)
                it = it + live.to(torch.int32)
                if i + 1 < iters:
                    live = (it < iters) & (rs > tol2)
        return x, rs, it


def richardson_refine(a_lo, a_hi, b, *, iters: int = 5, omega: float = 1.0, ar: str = "df64"):
    """Mixed-precision iterative refinement / Richardson iteration: the
    preconditioner's matvec streams the cheap storage copy `a_lo` (e.g.
    bf16), while the residual is taken against the accurate copy `a_hi`
    (f32) in `ar` arithmetic. Solves a x = b for a diagonally dominant a.

    Each iteration: r = b - A_hi x, then a two-term Neumann step through
    the cheap copy, dx = omega (2 r - omega A_lo r) ~= A^-1 r, so each
    iteration contracts by (I - omega A)^2. Returns (x, the (iters,) history
    of |r|^2)."""
    b32 = b.float()
    x = torch.zeros_like(b32)
    rhist = []
    for _ in range(iters):
        r = b32 - _matvec(a_hi, x, ar)
        x = x + omega * (2.0 * r - omega * _matvec(a_lo, r, ar))
        rhist.append(_dot(r, r, "f32"))
    return x, torch.stack(rhist)


def power_method(a, *, iters: int = 20, ar: str = "f32", seed: int = 0):
    """Dominant-eigenvalue estimate by the accessor GEMV and DOT: the start
    vector is the JAX package's, ``normal(key(seed), (n,))`` drawn on a's
    device (``utils.threefry``). Returns (the last iterate, the estimate)."""
    from ..utils import threefry

    x0 = threefry.normal(threefry.key(seed), (a.shape[1],), a.device)
    return power_iterate(a, x0, iters=iters, ar=ar)


def power_iterate(a, x0, *, iters: int = 20, ar: str = "f32"):
    """The power method from the start vector `x0`: x is normalised, then
    each iteration takes y = A x, the estimate x·y, and x = y / |y|."""
    x = x0.float()
    x = x / torch.sqrt(_dot(x, x, ar))
    lam = None
    for _ in range(iters):
        y = _matvec(a, x, ar)
        lam = _dot(x, y, ar)
        x = y / torch.sqrt(_dot(y, y, ar))
    return x, lam
