"""Differentiating THROUGH a sparse triangular solve — recover the values
of a lower-triangular operator from solution observations.

Given observations ``x_obs = T_true^{-1} b`` for a handful of right-hand
sides, fit the values of ``T`` on its (known) sparsity pattern by gradient
descent on ``||T^{-1} b - x_obs||^2``.  The level-scheduled plan fixes the
pattern once on the host; its value arrays (``offdiag_vals``,
``diag_vals``) are ordinary pytree leaves, so ``jax.grad`` flows through
the device-side level scan (``trisolve_apply``) with no re-planning while
the values move.

Run: python examples/implicit_fit.py
"""
import dataclasses
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import numpy as np
import optax
import scipy.sparse as sps

from sparsematrix_tpu.formats import CSR
from sparsematrix_tpu.ops import trisolve_apply, trisolve_plan


def main():
    rng = np.random.default_rng(0)
    n, k = 512, 4

    # ground truth: well-conditioned lower-triangular, random pattern
    m = sps.random(n, n, density=0.01, random_state=3, format="coo")
    keep = m.col < m.row
    r = np.concatenate([m.row[keep], np.arange(n)])
    c = np.concatenate([m.col[keep], np.arange(n)])
    v_true = np.concatenate([rng.uniform(-0.3, 0.3, keep.sum()),
                             rng.uniform(2.0, 3.0, n)]).astype(np.float32)
    T_true = CSR.from_scipy(sps.csr_matrix((v_true, (r, c)), shape=(n, n)))
    plan_true = trisolve_plan(T_true, lower=True)

    B = jnp.asarray(rng.standard_normal((n, k)).astype(np.float32))
    solve_all = jax.vmap(trisolve_apply, in_axes=(None, 1), out_axes=1)
    X_obs = solve_all(plan_true, B)

    # start from a perturbed operator on the same pattern
    def perturb(a):
        noise = rng.standard_normal(a.shape).astype(np.float32)
        return a * (1.0 + 0.25 * noise)

    params = (jnp.asarray(perturb(np.asarray(plan_true.offdiag_vals))),
              jnp.asarray(perturb(np.asarray(plan_true.diag_vals))))

    def loss(p):
        plan = dataclasses.replace(plan_true, offdiag_vals=p[0],
                                   diag_vals=p[1])
        return 0.5 * jnp.sum((solve_all(plan, B) - X_obs) ** 2)

    opt = optax.adam(0.03)
    state = opt.init(params)

    @jax.jit
    def step(p, s):
        L, g = jax.value_and_grad(loss)(p)
        upd, s = opt.update(g, s)
        return L, optax.apply_updates(p, upd), s

    L0 = None
    for i in range(150):
        L, params, state = step(params, state)
        if L0 is None:
            L0 = float(L)
        if i % 30 == 0 or i == 149:
            print(f"step {i:3d}  loss {float(L):.6f}")

    truth = np.asarray(plan_true.offdiag_vals)
    err = float(np.linalg.norm(np.asarray(params[0]) - truth)
                / np.linalg.norm(truth))
    print(f"relative off-diagonal error vs ground truth: {err:.4f}")
    # k·n observations vs nnz unknowns leaves the problem ill-conditioned;
    # success = the descent direction through the solve is right (loss
    # collapses by >100x), not a perfect recovery
    assert float(L) < L0 / 100, "fit did not converge"
    print("ok: gradient descent through the sparse solve fit T "
          f"(loss {L0:.2f} -> {float(L):.4f})")


if __name__ == "__main__":
    main()
