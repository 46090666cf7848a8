"""Codebook-quantized sparse MLP inference — the reference's production
use case (mobile speech/NN inference over cluster-quantized sparse weight
matrices) rebuilt on JAX.

Each layer's weight W (out×in) is stored transposed as CodebookDense
(uint8 indices into a ≤255-entry table, 4× smaller than fp32); the forward
pass is ``add_mat_mat`` per layer — a table-gather dequant fused by XLA
into one dense product.

Run: python examples/sparse_mlp.py
"""
import sys
import pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np
import jax
import jax.numpy as jnp

from sparsematrix_tpu.formats import CodebookDense
from sparsematrix_tpu.ops import add_mat_mat


def quantize_weight(rng, w, table_size=255, density=0.25):
    """K-means-free toy quantizer: keep `density` largest-magnitude weights,
    map each to its nearest of `table_size` uniform levels."""
    thresh = np.quantile(np.abs(w), 1 - density)
    mask = np.abs(w) >= thresh
    lo, hi = w[mask].min(), w[mask].max()
    table = np.linspace(lo, hi, table_size).astype(np.float32)
    idx = np.abs(w[..., None] - table).argmin(-1)
    idx = np.where(mask, idx, table_size)  # out-of-table = zero
    return idx, table


class SparseMLP:
    def __init__(self, rng, sizes, table_size=255, density=0.25):
        self.layers = []
        for d_in, d_out in zip(sizes[:-1], sizes[1:]):
            w = rng.normal(0, np.sqrt(2 / d_in), (d_out, d_in)).astype(np.float32)
            idx, table = quantize_weight(rng, w, table_size, density)
            # store W^T's encoding so layer matmul x @ W^T is a pure spmm:
            # add_mat_mat(x, W_enc) with W_enc = codebook(W) (shape out×in)
            self.layers.append(
                CodebookDense.from_index_matrix(idx, table)  # (out, in)
            )

    def __call__(self, x):
        # x: (batch, d_in); per layer: x @ W^T where W^T enc is layer (out,in)
        for i, w_enc in enumerate(self.layers):
            x = add_mat_mat(x, w_enc)  # (batch, out)
            if i < len(self.layers) - 1:
                x = jax.nn.relu(x)
        return x


def main():
    rng = np.random.default_rng(0)
    mlp = SparseMLP(rng, [512, 1024, 1024, 256])
    x = jnp.asarray(rng.normal(0, 1, (32, 512)).astype(np.float32))
    fwd = jax.jit(mlp.__call__)
    out = fwd(x)
    out.block_until_ready()
    print("forward ok:", out.shape, "mean|out| =", float(jnp.abs(out).mean()))

    # storage accounting
    dense_bytes = sum(w.idx.size * 4 for w in mlp.layers)
    enc_bytes = sum(w.idx.size * 1 + w.val_table.size * 4 for w in mlp.layers)
    print(f"weights: {dense_bytes/1e6:.1f} MB fp32-dense → "
          f"{enc_bytes/1e6:.1f} MB codebook ({dense_bytes/enc_bytes:.1f}x)")


if __name__ == "__main__":
    main()
