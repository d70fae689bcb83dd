"""Sinkhorn optimal transport with a dustbin, masked for fixed-shape batches
(pram_tpu/ops/sinkhorn.py).

The similarity ``[B, N, M]`` gets a learned dustbin row and column, is
softmaxed along rows, and a fixed number of (non-log) Sinkhorn iterations
turn it into a transport plan ``[B, N+1, M+1]``. Padded rows and columns
carry zero marginal mass, so the plan restricted to the valid entries is
that of the unpadded problem.

:func:`sinkhorn` replaces
``pram_tpu/ops/sinkhorn_pallas.py:sinkhorn_matching_pallas``, with a
gradient (:class:`SinkhornPlan`): a CPU tensor takes
:func:`sinkhorn_matching` forward, a CUDA tensor launches
``csrc/sinkhorn.cu`` or raises, and the backward recomputes the plain
iterations and differentiates them, as the JAX package differentiates its
XLA loop (it has no Sinkhorn backward kernel either). :func:`dual_softmax_matching`
has no kernel in either package.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from pram_tpu_torch._build import check_status, check_tensor, library, ptr, ptr_or_null, stream_of

# "sinkhorn": calls of the cluster instance; "sinkhorn_wide":
# of the wide one (the plan in device memory), which GML takes past 1535
# frame tokens
LAUNCHES = {"sinkhorn": 0, "sinkhorn_wide": 0}
# (device index, n, m) -> (cluster size, clusters the card places at once)
# of the instance that takes [n, m] problems; (WIDE, 0): the wide one
CLUSTERS = {}
WIDE = -1

_EPS = 1e-8


def _augment_with_dustbin(sim: torch.Tensor, dustbin) -> torch.Tensor:
    """Append a dustbin row and column filled with the learned scalar."""
    b, n, m = sim.shape
    bin_ = torch.as_tensor(dustbin, dtype=sim.dtype, device=sim.device)
    col = bin_.expand(b, n, 1)
    aug = torch.cat([sim, col], dim=-1)
    return torch.cat([aug, bin_.expand(b, 1, m + 1)], dim=-2)


def marginals(
    b: int, n: int, m: int, mask0, mask1, dtype, device
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row and column marginals ``[B, N+1]``, ``[B, M+1]``: 1 for a valid
    entry, 0 for a padded one, and (valid count + 1) for the dustbin."""

    def one(mask, k):
        if mask is None:
            valid = torch.ones((b, k), dtype=dtype, device=device)
            count = torch.full((b,), float(k + 1), dtype=dtype, device=device)
        else:
            valid = mask.to(dtype)
            count = valid.sum(-1) + 1.0
        return torch.cat([valid, count[:, None]], dim=-1)

    return one(mask0, n), one(mask1, m)


def sinkhorn_matching(
    sim: torch.Tensor,
    dustbin,
    num_iters: int = 20,
    mask0: Optional[torch.Tensor] = None,
    mask1: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sinkhorn transport plan with dustbin ``[B, N+1, M+1]`` (plain torch)."""
    b, n, m = sim.shape
    aug = _augment_with_dustbin(sim, dustbin)
    r, c = marginals(b, n, m, mask0, mask1, sim.dtype, sim.device)
    p = torch.softmax(aug, dim=-1)
    u = torch.ones_like(r)
    v = torch.ones_like(c)
    for _ in range(num_iters):
        u = r / (torch.einsum("bnm,bm->bn", p, v) + _EPS)
        v = c / (torch.einsum("bnm,bn->bm", p, u) + _EPS)
    return p * u[:, :, None] * v[:, None, :]


def dual_softmax_matching(
    sim: torch.Tensor,
    dustbin,
    mask0: Optional[torch.Tensor] = None,
    mask1: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dual-softmax score with dustbin; padded rows/columns are pushed to
    -1e9 before the softmaxes and zeroed in the output."""
    b = sim.shape[0]
    aug = _augment_with_dustbin(sim, dustbin)
    neg = torch.tensor(-1e9, dtype=aug.dtype, device=aug.device)
    ones = torch.ones((b, 1), dtype=torch.bool, device=sim.device)
    rm = cm = None
    if mask0 is not None:
        rm = torch.cat([mask0, ones], dim=-1)
        aug = torch.where(rm[:, :, None], aug, neg)
    if mask1 is not None:
        cm = torch.cat([mask1, ones], dim=-1)
        aug = torch.where(cm[:, None, :], aug, neg)
    out = torch.exp(torch.log_softmax(aug, dim=-1) + torch.log_softmax(aug, dim=-2))
    if rm is not None:
        out = out * rm[:, :, None]
    if cm is not None:
        out = out * cm[:, None, :]
    return out


def instance(n: int, m: int, device) -> Tuple[int, int]:
    """The CUDA instance that takes ``[n, m]`` problems on ``device``, as
    ``(cluster size, clusters the card places at once)``: the cluster
    instance where a cluster of 16 blocks holds the n + 1 rows in shared
    memory (m + 1 <= 1152 and ceil((n + 1) / 16) rows of m + 1 floats, with
    v and the exchange's scratch, within 227 KB a block: n <= 863 at m =
    1024; GML's 512 x 1024 takes 141 KB) and the card places one, else the
    smallest cluster whose rows fit and that it places; ``(WIDE, 0)`` for
    the wide instance, which takes every other shape (the plan in device
    memory). Asked of the
    card (cudaOccupancyMaxActiveClusters) once a shape and kept in
    :data:`CLUSTERS`."""
    dev = torch.device(device)
    key = (dev.index if dev.index is not None else torch.cuda.current_device(), n, m)
    if key not in CLUSTERS:
        size, active = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(key[0]):
            check_status(
                library().pram_sinkhorn_plan(n, m, ctypes.byref(size), ctypes.byref(active)),
                "pram_sinkhorn_plan",
            )
        CLUSTERS[key] = (size.value, active.value)
    return CLUSTERS[key]


def _check_fits(n_bytes: int, dev: torch.device, what: str) -> None:
    """Raise unless ``n_bytes`` more fit the card: its free memory and what
    PyTorch's caching allocator holds unused."""
    free, _ = torch.cuda.mem_get_info(dev)
    spare = free + torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
    if n_bytes > spare:
        raise ValueError(f"{what} needs {n_bytes / 2**30:.2f} GiB; the card has {spare / 2**30:.2f} GiB to spare")


def _launch(sim: torch.Tensor, dustbin: torch.Tensor, num_iters: int, mask0, mask1) -> torch.Tensor:
    """One call of ``csrc/sinkhorn.cu`` on ``sim``'s card. The instance is
    chosen by shape before the call (:func:`instance`): the cluster
    instance, which keeps the plan in a 16-block cluster's shared memory,
    for every shape whose rows fit it; the wide instance, which keeps the
    plan in the output and iterates the scaling vectors (2 ``num_iters`` +
    1 launches), for the rest. A failed launch
    raises, and so does a wide problem that does not fit the card's
    memory."""
    b, n, m = sim.shape
    dev = sim.device
    f32 = torch.float32
    cluster, _ = instance(n, m, dev)
    work = None
    if cluster == WIDE:
        scratch = b * (n + m + 2)
        _check_fits(4 * (b * (n + 1) * (m + 1) + scratch), dev, f"the Sinkhorn plan of {b} x {n} x {m}")
        work = torch.empty(scratch, dtype=f32, device=dev)
    check_tensor(sim, "sim", (b, n, m), f32, dev)
    r, c = marginals(b, n, m, mask0, mask1, f32, dev)
    check_tensor(r, "row marginals (mask0)", (b, n + 1), f32, dev)
    check_tensor(c, "column marginals (mask1)", (b, m + 1), f32, dev)
    out = torch.empty((b, n + 1, m + 1), dtype=f32, device=dev)
    bin_ = dustbin.to(device=dev, dtype=f32).reshape(1).contiguous()
    check_status(
        library().pram_sinkhorn(
            ptr(sim), ptr(r), ptr(c), ptr(bin_), ptr(out), b, n, m, num_iters, cluster,
            ptr_or_null(work), stream_of(dev),
        ),
        "pram_sinkhorn",
    )
    LAUNCHES["sinkhorn_wide" if cluster == WIDE else "sinkhorn"] += 1
    return out


class SinkhornPlan(torch.autograd.Function):
    """The plan of :func:`sinkhorn` with gradients for ``sim`` and the
    dustbin score.

    Forward: the kernel (:func:`_launch`) on a CUDA tensor,
    :func:`sinkhorn_matching` on a CPU one. Backward:
    :func:`sinkhorn_matching`'s iterations recomputed from the saved
    ``sim``, dustbin and masks and differentiated by autograd; no
    ``[B, N+1, M+1]`` tensor is kept between the passes. The kernel's plan
    and the plain one differ in f32 summation order (the dustbin row and
    column by ~0.2% of their mass, ``SINKHORN_DUSTBIN_RTOL`` in
    ``chip_smoke.py``), so on the card the gradient is that of the plain plan
    at the kernel plan's cotangent. The masks get no gradient.
    """

    @staticmethod
    def forward(ctx, sim, dustbin, num_iters, mask0, mask1):
        ctx.save_for_backward(sim, dustbin, mask0, mask1)
        ctx.num_iters = num_iters
        if sim.device.type == "cpu":
            return sinkhorn_matching(sim, dustbin, num_iters, mask0, mask1)
        return _launch(sim, dustbin, num_iters, mask0, mask1)

    @staticmethod
    def backward(ctx, g):
        sim, dustbin, mask0, mask1 = ctx.saved_tensors
        with torch.enable_grad():
            s = sim.detach().requires_grad_()
            d = dustbin.detach().requires_grad_()
            plan = sinkhorn_matching(s, d.to(s.dtype), ctx.num_iters, mask0, mask1)
            dsim, dbin = torch.autograd.grad(plan, (s, d), g)
        return dsim, dbin, None, None, None


def sinkhorn(
    sim: torch.Tensor,
    dustbin,
    num_iters: int = 20,
    mask0: Optional[torch.Tensor] = None,
    mask1: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sinkhorn transport plan with dustbin ``[B, N+1, M+1]``:
    :func:`sinkhorn_matching` on the CPU, ``csrc/sinkhorn.cu`` on CUDA, with
    a gradient for ``sim`` and a learned dustbin either way
    (:class:`SinkhornPlan`); under ``torch.no_grad()`` the forward alone.
    ``dustbin`` is a 0-d tensor or a float; the kernel reads it from the
    device."""
    bin_ = dustbin if torch.is_tensor(dustbin) else torch.tensor(float(dustbin), device=sim.device)
    return SinkhornPlan.apply(sim, bin_, num_iters, mask0, mask1)
