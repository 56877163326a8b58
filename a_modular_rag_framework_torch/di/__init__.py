"""The port's copy of ``a_modular_rag_framework_tpu/di/__init__.py``.
"""
from .factory import (
    build_dataset_loader_from_settings,
    build_modules,
    build_providers,
    build_router,
    filtered_kwargs,
    import_from_string,
    load_settings,
    parse_module_spec,
    resolve_env,
)

__all__ = [
    "build_dataset_loader_from_settings",
    "build_modules",
    "build_providers",
    "build_router",
    "filtered_kwargs",
    "import_from_string",
    "load_settings",
    "parse_module_spec",
    "resolve_env",
]
