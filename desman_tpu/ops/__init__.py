"""Pallas GPU kernels for the sampler hot path."""

from .tau_pallas import tau_sweep_pallas


def resolve_tau_sweep(kernel):
    """Kernel name -> tau_sweep fn (None = caller's default, the XLA path).

    Single source of truth for the CLI/pipeline ``kernel`` option; unknown
    names raise instead of silently running the default.
    """
    if kernel in (None, "", "xla"):
        return None
    if kernel == "pallas":
        return tau_sweep_pallas
    raise ValueError(f"unknown tau kernel {kernel!r}; one of: xla, pallas")


__all__ = ["tau_sweep_pallas", "resolve_tau_sweep"]
