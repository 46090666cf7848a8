"""Platform rules for sparsematrix_tpu.

Every device path is plain ``jax.numpy``/``lax`` compiled by XLA, so the
only decision keyed on the platform is which collective carries the
variable-width halo of ``parallel.dist_spmv_halo_var``.
"""
from __future__ import annotations

from dataclasses import dataclass, field


def _default_backend() -> str:
    import jax

    return jax.default_backend()


# backends whose XLA lowers ``lax.ragged_all_to_all``; XLA:CPU has no
# ragged-all-to-all kernel, so the CPU takes the padded ppermute exchange
_RAGGED_A2A_BACKENDS = ("gpu",)


@dataclass
class Config:
    _backend: str | None = field(default=None, repr=False)

    @property
    def backend(self) -> str:
        if self._backend is None:
            self._backend = _default_backend()
        return self._backend

    def ragged_halo(self) -> bool:
        """Whether ``dist_spmv_halo_var`` exchanges halos with
        ``ragged_all_to_all`` (True) or the padded ppermute (False)."""
        return self.backend in _RAGGED_A2A_BACKENDS


config = Config()
