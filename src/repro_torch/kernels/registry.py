"""Discovery of the port's kernel packages (the counterpart of
``repro.kernels.registry``).

Every subpackage of :mod:`repro_torch.kernels` that exports a module-level
``SPEC: KernelSpec`` is a registered kernel. The kernel audit
(:mod:`repro_torch.analysis.kernel_audit`) iterates
:func:`registered_kernels`, so a new kernel package is audited the moment
it exists. Discovery imports the package ``__init__`` modules only; none
touches the card or builds a kernel at import time.
"""

from __future__ import annotations

import importlib
import pkgutil

from .spec import KernelSpec


def registered_kernels() -> dict[str, KernelSpec]:
    """Return ``{name: spec}`` for every kernel package, sorted by name."""
    import repro_torch.kernels as root

    specs: dict[str, KernelSpec] = {}
    for info in pkgutil.iter_modules(root.__path__):
        if not info.ispkg:
            continue
        mod = importlib.import_module(f"{root.__name__}.{info.name}")
        spec = getattr(mod, "SPEC", None)
        if spec is None:
            continue
        if not isinstance(spec, KernelSpec):
            raise TypeError(f"{mod.__name__}.SPEC is not a KernelSpec")
        if spec.name != info.name:
            raise ValueError(f"{mod.__name__}.SPEC.name {spec.name!r} "
                             f"does not match its package name")
        specs[spec.name] = spec
    return dict(sorted(specs.items()))


def get_kernel_spec(name: str) -> KernelSpec:
    """Look up one registered kernel spec by name."""
    specs = registered_kernels()
    if name not in specs:
        raise KeyError(f"unknown kernel {name!r} "
                       f"(registered: {sorted(specs)})")
    return specs[name]
