"""Triangle counting on an undirected graph — SpGEMM workload.

Triangles(G) = trace(A³)/6 = Σ (A² ∘ A)/6 for an undirected adjacency A.
The SpGEMM runs through the pair program with CSC output
(``spgemm(..., output="csc")``, planned as Aᵀ @ Aᵀ); the Hadamard
mask + reduction stay on-device.  For a symmetric A the CSC result IS
A²'s CSR transpose, and trace-based counting is orientation-free, so the
transposed structure costs nothing here.

Run: python examples/triangle_count.py
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np
import jax.numpy as jnp

from sparsematrix_tpu.formats import CSR
from sparsematrix_tpu.ops.spgemm import spgemm


def main():
    rng = np.random.default_rng(0)
    n = 1500
    # undirected graph, ~16 neighbors per node
    upper = np.triu((rng.random((n, n)) < 16 / n), k=1)
    dense = (upper | upper.T).astype(np.float32)
    A = CSR.fromdense(dense)

    # A² in CSC form (= (A²)^T CSR; A² is symmetric so the orientation is
    # irrelevant) — the permutation-free numeric phase
    A2t = spgemm(A, A, output="csc")

    # Hadamard with A's pattern + total: gather A² at A's stored entries
    A2_dense = jnp.asarray(A2t.todense()).T
    mask = jnp.asarray(dense) != 0
    tri = float(jnp.sum(jnp.where(mask, A2_dense, 0.0))) / 6.0

    # oracle
    d64 = dense.astype(np.float64)
    want = float(np.trace(d64 @ d64 @ d64)) / 6.0
    print(f"triangles: {tri:.0f} (oracle {want:.0f})")
    assert abs(tri - want) < 0.5 * max(want, 1), (tri, want)
    print("OK")


if __name__ == "__main__":
    main()
