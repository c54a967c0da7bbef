"""Module API: BaseModule (the fit loop) and Module (one Symbol on one
device)."""
from .base_module import BaseModule
from .module import Module, params_from_jax

__all__ = ["BaseModule", "Module", "params_from_jax"]
