"""2-D Poisson equation solved with ILU(0)-preconditioned CG — the
trisolve/ILU/solver stack end to end.

Run: python examples/poisson_pcg.py
"""
import sys
import pathlib
import functools

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np
import jax.numpy as jnp

from sparsematrix_tpu.formats import CSR
from sparsematrix_tpu.ops import ilu0_plans, ilu_apply
from sparsematrix_tpu.solvers import cg


def poisson2d(nx):
    """5-point Laplacian on an nx×nx grid."""
    n = nx * nx
    a = np.zeros((n, n), dtype=np.float32)
    for i in range(nx):
        for j in range(nx):
            k = i * nx + j
            a[k, k] = 4.0
            for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                ii, jj = i + di, j + dj
                if 0 <= ii < nx and 0 <= jj < nx:
                    a[k, ii * nx + jj] = -1.0
    return a


def main():
    nx = 24
    a = poisson2d(nx)
    A = CSR.fromdense(a)
    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.uniform(-1, 1, nx * nx).astype(np.float32))

    plain = cg(A, b, tol=1e-8, maxiter=2000)
    # level-scheduled plans: each triangular solve is one scan over levels
    plans = ilu0_plans(A)
    pre = cg(A, b, tol=1e-8, maxiter=2000,
             M=functools.partial(ilu_apply, plans))
    res = np.linalg.norm(a @ np.asarray(pre.x) - np.asarray(b))
    print(f"CG iters: plain={int(plain.iters)}  ILU(0)-PCG={int(pre.iters)}  "
          f"final residual={res:.2e}")


if __name__ == "__main__":
    main()
