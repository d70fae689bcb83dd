"""The cluster-resident Sinkhorn (csrc/sinkhorn.cu, kernel 6's cluster
instance) and its wide instance, mirrored in torch f32 on the CPU.

One cluster of CS = 16 blocks takes a problem. Block k owns rows [k rb,
(k + 1) rb) of the softmaxed, dustbin-augmented plan P [n + 1, m + 1], rb =
ceil((n + 1) / CS) (the last blocks may own fewer rows, or none). An
iteration:
- each block computes u for its rows, u_i = r_i / (P_i . v + 1e-8), with
  the full v;
- each block sums P_ij u_i over its rows, in row order, into a partial
  column vector;
- block k takes column slice k, [k sl, (k + 1) sl) with sl = ceil((m + 1)
  / CS), of all 16 partials, sums them in rank order, and computes v_j =
  c_j / (sum + 1e-8) for its slice, which every block then holds.
The plan is (P * u) * v. The sums inside a row dot are the kernel's own
(a thread's column pairs, a warp's shuffles, the 16 warps in order); here
torch's, so the mirror holds the decomposition, not the bits.

The wide instance (every shape no cluster holds: m + 1 > 1152, or rows
past a cluster's shared memory; GML at the Aachen shape) keeps P in
device memory and iterates only u and v: u of the first iteration from the
softmax pass (v = 1); each column pass sums P_ij u_i for a column over the
rows w, w + 16, ... in order in warp w, then the 16 partials in warp order;
each row pass takes u_i = r_i / (P_i . v + 1e-8).

Tolerances (chip_smoke.py's SINKHORN_ATOL / SINKHORN_DUSTBIN_RTOL): the
real block within 1e-4 absolute of ``ops/sinkhorn.py:sinkhorn_matching``,
of the JAX package's ``sinkhorn_matching`` and of its Pallas kernel in
interpret mode; the dustbin row and column within 3e-3 relative: the
dustbin's scaling factors sit near a degenerate fixed point that amplifies
f32 summation order (pram_tpu/ops/sinkhorn_pallas.py:12-15).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pram_tpu.ops.sinkhorn import sinkhorn_matching as jax_sinkhorn
from pram_tpu.ops.sinkhorn_pallas import sinkhorn_matching_pallas
from pram_tpu_torch.ops.sinkhorn import _augment_with_dustbin, marginals, sinkhorn_matching

CS = 16
EPS = 1e-8
ATOL, DUSTBIN_RTOL = 1e-4, 3e-3


def cluster_sinkhorn(sim, dustbin, num_iters=20, mask0=None, mask1=None, cs=CS):
    """The cluster instance's decomposition of one batch of problems."""
    b, n, m = sim.shape
    n1, m1 = n + 1, m + 1
    rb, sl = -(-n1 // cs), -(-m1 // cs)
    p = torch.softmax(_augment_with_dustbin(sim, dustbin), dim=-1)
    r, c = marginals(b, n, m, mask0, mask1, sim.dtype, sim.device)
    rows = [slice(min(k * rb, n1), min((k + 1) * rb, n1)) for k in range(cs)]
    cols = [slice(min(k * sl, m1), min((k + 1) * sl, m1)) for k in range(cs)]
    u = torch.ones_like(r)
    v = torch.ones_like(c)
    for _ in range(num_iters):
        parts = []
        for blk in rows:
            pk = p[:, blk]
            u[:, blk] = r[:, blk] / (torch.einsum("bnm,bm->bn", pk, v) + EPS)
            part = torch.zeros_like(v)
            for i in range(pk.shape[1]):  # rows in order
                part = part + pk[:, i] * u[:, blk][:, i, None]
            parts.append(part)
        v_new = torch.empty_like(v)
        for sk in cols:
            total = torch.zeros_like(v[:, sk])
            for part in parts:  # rank order
                total = total + part[:, sk]
            v_new[:, sk] = c[:, sk] / (total + EPS)
        v = v_new
    return (p * u[:, :, None]) * v[:, None, :]


def _check(got, ref, n, m):
    np.testing.assert_allclose(got[:, :n, :m], ref[:, :n, :m], rtol=0, atol=ATOL)
    for a, r in ((got[:, n], ref[:, n]), (got[:, :, m], ref[:, :, m])):
        rel = np.abs(a - r) / np.maximum(np.abs(r), 1e-6)
        assert rel.max() <= DUSTBIN_RTOL, rel.max()


def _inputs(b, n, m, masked, seed):
    rng = np.random.RandomState(seed)
    sim = (rng.randn(b, n, m) * 3).astype(np.float32)
    if not masked:
        return sim, None, None
    m0 = rng.rand(b, n) > 0.1
    m1 = rng.rand(b, m) > 0.4
    return sim, m0, m1


# (n, m): n + 1 = 41 and 101 rows do not divide by 16 (the last blocks own
# fewer rows, at 41 some none); 20 x 7 leaves blocks without rows and
# columns
SHAPES = [(40, 70), (100, 200), (20, 7)]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n,m", SHAPES)
def test_cluster_decomposition_matches_plain(masked, n, m):
    sim, m0, m1 = _inputs(2, n, m, masked, n + m)
    t = torch.from_numpy
    tm = (None, None) if not masked else (t(m0), t(m1))
    got = cluster_sinkhorn(t(sim), torch.tensor(1.2), 20, *tm).numpy()
    ref = sinkhorn_matching(t(sim), torch.tensor(1.2), 20, *tm).numpy()
    _check(got, ref, n, m)
    if masked:
        assert (got[:, :n][~m0] == 0).all()
        assert (got[:, :, :m].transpose(0, 2, 1)[~m1] == 0).all()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n,m", SHAPES[:2])
def test_cluster_decomposition_matches_jax(masked, n, m):
    """Against the JAX package's XLA Sinkhorn and its Pallas kernel in
    interpret mode, on the same numpy inputs."""
    sim, m0, m1 = _inputs(2, n, m, masked, 3 * n + m)
    jm = (None, None) if not masked else (jnp.asarray(m0), jnp.asarray(m1))
    tm = (None, None) if not masked else (torch.from_numpy(m0), torch.from_numpy(m1))
    got = cluster_sinkhorn(torch.from_numpy(sim), torch.tensor(0.8), 20, *tm).numpy()
    xla = np.asarray(jax_sinkhorn(jnp.asarray(sim), jnp.asarray(0.8), 20, *jm))
    pal = np.asarray(sinkhorn_matching_pallas(jnp.asarray(sim), jnp.asarray(0.8), 20, *jm, interpret=True))
    _check(got, xla, n, m)
    _check(got, pal, n, m)


@pytest.mark.parametrize("cs", [1, 3, 16])
def test_cluster_size_does_not_change_the_plan(cs):
    """The smaller clusters the instance may take where 16 cannot be placed
    give the same plan within the tolerance."""
    sim, m0, m1 = _inputs(1, 50, 90, True, cs)
    t = torch.from_numpy
    got = cluster_sinkhorn(t(sim), torch.tensor(1.0), 20, t(m0), t(m1), cs=cs).numpy()
    ref = sinkhorn_matching(t(sim), torch.tensor(1.0), 20, t(m0), t(m1)).numpy()
    _check(got, ref, 50, 90)


WARPS = 16


def wide_sinkhorn(sim, dustbin, num_iters=20, mask0=None, mask1=None):
    """The wide instance's decomposition of one batch of problems."""
    b, n, m = sim.shape
    p = torch.softmax(_augment_with_dustbin(sim, dustbin), dim=-1)
    r, c = marginals(b, n, m, mask0, mask1, sim.dtype, sim.device)
    u = r / (p.sum(-1) + EPS) if num_iters else torch.ones_like(r)
    v = torch.ones_like(c)
    for it in range(num_iters):
        if it > 0:
            u = r / (torch.einsum("bnm,bm->bn", p, v) + EPS)
        total = torch.zeros_like(v)
        for w in range(WARPS):  # warp order
            part = torch.zeros_like(v)
            for i in range(w, n + 1, WARPS):  # this warp's rows in order
                part = part + p[:, i] * u[:, i, None]
            total = total + part
        v = c / (total + EPS)
    return (p * u[:, :, None]) * v[:, None, :]


# m + 1 past the cluster instance's 1152 columns; n + 1 = 31 and 8 rows
# leave warps without rows
WIDE_SHAPES = [(30, 1600), (7, 1537)]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n,m", WIDE_SHAPES)
def test_wide_decomposition_matches_plain_and_jax(masked, n, m):
    """The wide instance's decomposition against the port's plain version
    and the JAX package's XLA Sinkhorn (the GML default,
    pram_tpu/models/gml.py:43,116), on the same numpy inputs."""
    sim, m0, m1 = _inputs(2, n, m, masked, 5 * n + m)
    t = torch.from_numpy
    tm = (None, None) if not masked else (t(m0), t(m1))
    jm = (None, None) if not masked else (jnp.asarray(m0), jnp.asarray(m1))
    got = wide_sinkhorn(t(sim), torch.tensor(1.1), 20, *tm).numpy()
    _check(got, sinkhorn_matching(t(sim), torch.tensor(1.1), 20, *tm).numpy(), n, m)
    _check(got, np.asarray(jax_sinkhorn(jnp.asarray(sim), jnp.asarray(1.1), 20, *jm)), n, m)
    if masked:
        assert (got[:, :n][~m0] == 0).all()
        assert (got[:, :, :m].transpose(0, 2, 1)[~m1] == 0).all()


def test_wide_decomposition_without_iterations():
    """num_iters = 0: the softmaxed plan itself (u = v = 1)."""
    sim, _, _ = _inputs(1, 9, 1600, False, 1)
    t = torch.from_numpy
    got = wide_sinkhorn(t(sim), torch.tensor(1.0), 0).numpy()
    ref = sinkhorn_matching(t(sim), torch.tensor(1.0), 0).numpy()
    np.testing.assert_array_equal(got, ref)
