"""JAX runtime configuration: the persistent compilation cache."""
import os
from pathlib import Path
from typing import Optional

from .logger import log


def checkout_cache_dir(package_file: str = __file__) -> Optional[Path]:
    """``.jax_cache/`` at the root of the checkout this package runs from
    (listed in .gitignore), or None for an installed package: there the
    directory above the package is site-packages' parent, not ours."""
    root = Path(package_file).resolve().parents[2]
    return root / ".jax_cache" if (root / "pyproject.toml").is_file() else None


# Used when JAX_COMPILATION_CACHE_DIR is unset: one fixed directory inside
# the checkout, so every run of the same checkout finds the programs earlier
# runs compiled. An installed package keeps no persistent cache.
DEFAULT_CACHE_DIR = checkout_cache_dir()

_CACHE_SET = False


def compile_cache_dir() -> Optional[str]:
    """JAX_COMPILATION_CACHE_DIR when set, else DEFAULT_CACHE_DIR (or None)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    return str(DEFAULT_CACHE_DIR) if DEFAULT_CACHE_DIR else None


def enable_compile_cache() -> None:
    """Enable JAX's persistent compilation cache (idempotent).

    With JAX_COMPILATION_CACHE_DIR set, JAX already reads it and no other
    directory is set here. Without it and outside a checkout, or where the
    checkout's directory cannot be made, the run goes on without a persistent
    cache. Must run before the first compile to cover it."""
    global _CACHE_SET
    if _CACHE_SET:
        return
    import jax

    _CACHE_SET = True
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        if DEFAULT_CACHE_DIR is None:
            log.info("No persistent compile cache: JAX_COMPILATION_CACHE_DIR "
                     "is unset and the package does not run from a checkout.")
            return
        try:
            os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
        except OSError as e:
            log.info(f"No persistent compile cache: {e}")
            return
        jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
