"""The port's batched ring-cost evaluator against the reference's.

``ring_cost_batch`` and ``make_ring_evaluator`` on the CPU (asked for
explicitly) against ``repro.kernels.solver_eval``'s jitted f32 evaluator,
within a relative 1e-6 (both sum in f32, in another order), and against
the f64 ``cost_batch``; and ``solve_sa(backend="jax")`` against the
reference's ``backend="jax"`` on seed 0, both engines, N = 16 and 64.
What the run shows: the reported costs are equal (both recomputed in
f64) and the tours are the same ring (up to rotation and direction);
the trace's f32 costs part within 1e-6 relative; at N = 16 the list of
improving iterations and the tour's rotation differ (an f32 near-tie
decided the other way), at N = 64 they agree.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

import repro.core.cost_models as R_cm  # noqa: E402
import repro.core.solver as R_so  # noqa: E402
from repro.kernels import solver_eval as R_se  # noqa: E402
import repro_torch.core.cost_models as T_cm  # noqa: E402
import repro_torch.core.solver as T_so  # noqa: E402
from repro_torch.kernels import solver_eval as T_se  # noqa: E402


def _ring_matrix(n, seed):
    rng = np.random.default_rng(seed)
    c = rng.random((n, n))
    return (c + c.T) / 2


def _canonical(perm):
    """A ring as a sequence from node 0 in its smaller direction."""
    p = [int(v) for v in perm]
    i = p.index(0)
    r = p[i:] + p[:i]
    return min(r, [r[0]] + r[1:][::-1])


def test_ring_cost_batch_and_evaluator_equal_the_references():
    n = 64
    c = _ring_matrix(n, 3)
    rng = np.random.default_rng(4)
    perms = np.stack([rng.permutation(n) for _ in range(32)])
    want = R_se.ring_cost_batch(c, perms)
    got = T_se.ring_cost_batch(c, perms, device="cpu")
    assert got.dtype == np.float64 and got.shape == (32,)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    exact = T_cm.make_cost_model("ring", cost_matrix=c, size_bytes=1.0
                                 ).cost_batch(perms)
    np.testing.assert_allclose(got, exact, rtol=1e-6)
    evaluate = T_se.make_ring_evaluator(c, device="cpu")
    ref_eval = R_se.make_ring_evaluator(c)
    np.testing.assert_allclose(evaluate(perms), ref_eval(perms), rtol=1e-6)
    np.testing.assert_array_equal(evaluate(perms), got)
    # one permutation, as the reference takes it
    np.testing.assert_allclose(evaluate(perms[0]), ref_eval(perms[0]), rtol=1e-6)
    assert evaluate(perms[0]).shape == (1,)
    if not torch.cuda.is_available():
        # cuda by default, and no fall-back to numpy or the CPU
        for call in (lambda: T_se.ring_cost_batch(c, perms),
                     lambda: T_se.make_ring_evaluator(c)):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()


@pytest.mark.parametrize("engine", ["vectorized", "reference"])
@pytest.mark.parametrize("n", [16, 64])
def test_solve_sa_jax_backend_against_the_references(n, engine):
    c = _ring_matrix(n, 0)
    kw = dict(iters=600, chains=8, seed=0, engine=engine, backend="jax")
    got = T_so.solve_sa(T_cm.make_cost_model("ring", cost_matrix=c,
                                             size_bytes=1e6), device="cpu", **kw)
    want = R_so.solve_sa(R_cm.make_cost_model("ring", cost_matrix=c,
                                              size_bytes=1e6), **kw)
    assert got.cost == want.cost
    assert _canonical(got.perm) == _canonical(want.perm)
    assert got.trace[0][1] == want.trace[0][1] == 0
    assert got.trace[0][2] == pytest.approx(want.trace[0][2], rel=1e-6)
    same_steps = [t[1] for t in got.trace] == [t[1] for t in want.trace]
    assert same_steps == (n == 64)
    if same_steps:
        for a, b in zip(got.trace, want.trace):
            assert a[2] == pytest.approx(b[2], rel=1e-6)
    # the numpy backend on the same seed: the same tour
    numpy = T_so.solve_sa(T_cm.make_cost_model("ring", cost_matrix=c,
                                               size_bytes=1e6),
                          **dict(kw, backend="numpy"))
    assert _canonical(numpy.perm) == _canonical(got.perm)
