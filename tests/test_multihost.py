"""initialize_multihost executed for real (single-process distributed
runtime on CPU — jax.distributed supports num_processes=1), in a
subprocess so the coordinator's global state never leaks into this
process.  A real N-host run needs a cluster."""
import subprocess
import sys

SCRIPT = r"""
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from sparsematrix_tpu.parallel.multihost import initialize_multihost, global_mesh

initialize_multihost("localhost:12399", num_processes=1, process_id=0)
assert jax.process_count() == 1, jax.process_count()
mesh = global_mesh()
assert mesh.devices.size == len(jax.devices())
# a collective over the global mesh must execute
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
try:
    from jax import shard_map
except ImportError:
    from jax.experimental.shard_map import shard_map
import functools

n = mesh.devices.size


@functools.partial(shard_map, mesh=mesh, in_specs=P("shard"),
                   out_specs=P())
def total(x):
    return jax.lax.psum(jnp.sum(x), "shard")[None]


x = jnp.arange(float(8 * n))
got = float(total(x.reshape(n, -1))[0]) if n > 1 else float(
    total(x.reshape(n, -1))[0])
assert got == float(x.sum()), (got, float(x.sum()))
print("MULTIHOST_OK")
"""


def test_initialize_multihost_single_process():
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin:/usr/local/bin"}
    import os

    env["PYTHONPATH"] = os.pathsep.join(sys.path)
    out = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, (out.stdout, out.stderr)
    assert "MULTIHOST_OK" in out.stdout
