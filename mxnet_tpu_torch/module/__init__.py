"""Module API: BaseModule (the fit loop), Module (one Symbol on one
device), BucketingModule, SequentialModule, PythonModule,
PythonLossModule and PipelineModule (pipeline parallelism over a 'pipe'
mesh axis)."""
from .base_module import BaseModule
from .module import Module, params_from_jax
from .bucketing_module import BucketingModule
from .sequential_module import SequentialModule
from .python_module import PythonModule, PythonLossModule
from .pipeline_module import PipelineModule

__all__ = ["BaseModule", "BucketingModule", "Module", "PipelineModule",
           "PythonLossModule", "PythonModule", "SequentialModule",
           "params_from_jax"]
