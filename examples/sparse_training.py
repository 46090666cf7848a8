"""Training through the sparse ops — gradient descent on the stored
values of a fixed sparsity pattern (static-sparsity training).

``CSR.data`` is a pytree leaf, so ``jax.grad`` of a loss through ``spmv``
gives the gradient of every stored value while the pattern stays fixed.
The reference is inference-only; autodiff through every op is a
capability a JAX-native library owes its users.

Run: python examples/sparse_training.py
"""
import dataclasses
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import numpy as np

from sparsematrix_tpu.formats import CSR
from sparsematrix_tpu.ops import spmv


def main():
    rng = np.random.default_rng(0)
    n, m = 512, 2048
    # fixed random sparsity pattern, learnable values
    dense = (rng.random((n, m)) < 0.05).astype(np.float32)
    dense *= rng.standard_normal((n, m)).astype(np.float32)
    A0 = CSR.fromdense(dense)

    # regression target from a hidden dense teacher
    W_true = rng.standard_normal((n, m)).astype(np.float32) * 0.1
    x = rng.standard_normal(m).astype(np.float32)
    y = W_true @ x

    def loss_fn(data, x, y):
        pred = spmv(dataclasses.replace(A0, data=data), x)
        return jnp.mean((pred - y) ** 2)

    @jax.jit
    def step(data, x, y, lr):
        loss, g = jax.value_and_grad(loss_fn)(data, x, y)
        return loss, data - lr * g  # only the values train

    data = A0.data
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    for i in range(30):
        loss, data = step(data, xj, yj, 1e-3)
        if i % 10 == 0:
            print(f"step {i:3d}  loss {float(loss):.4f}")
    start = float(loss_fn(A0.data, xj, yj))
    print(f"final loss {float(loss):.4f} (started ~{start:.4f})")
    assert float(loss) < start
    print("OK: gradients flow through the CSR SpMV")


if __name__ == "__main__":
    main()
